"""icl_tpu_torch SwinUNETR against the JAX package's: the geometry helpers,
the weight carry (`utils/convert.py` against `export_swinunetr`), and the
full forward, with JAX on its einsum path and through its Pallas kernels
in interpret mode.

Small size: feature_size 12, heads (3, 6, 12, 24) so head dim 4, window
7, patch 32^3. Stages 1-2 then shift with N = 343 (region-id masks),
stages 3-4 shrink the window (N = 64, 8) and take the `[:N, :N]` slice
of the 7^3 relative-position index.
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models import swinunetr as jax_swin
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.utils.torch_import import export_swinunetr

from icl_tpu_torch.models import swinunetr as port_swin
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.utils.convert import swinunetr_state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

FS = 12
PATCH = 32


@functools.cache
def _jax_swinunetr_and_shapes():
    model = jax_net_factory("swinunetr", 1, 2, feature_size=FS)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PATCH, PATCH, PATCH, 1)), train=False))
    return model, shapes["params"]


def jax_swinunetr_params(seed: int):
    """(JAX SwinUNETR module, params) with every leaf drawn from a numpy
    generator: kernels ~ N(0, 1/fan_in), biases and norm shifts ~ N(0,
    0.1^2), norm scales ~ 1 + N(0, 0.1^2), bias tables ~ N(0, 0.5^2)."""
    model, shapes = _jax_swinunetr_and_shapes()
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        shape = leaf.shape
        if keys[-1] == "kernel":
            stacked = "blocks" in keys  # nn.scan stacks block params on axis 0
            fan_in = math.prod(shape[1:-1] if stacked else shape[:-1])
            return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if keys[-1] == "relative_position_bias_table":
            return (0.5 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, params


def port_model(params):
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FS)
    model.load_state_dict(swinunetr_state_dict_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("dims,window,shift", [
    ((16, 16, 16), (7, 7, 7), (3, 3, 3)),
    ((8, 8, 8), (7, 7, 7), (3, 3, 3)),
    ((4, 4, 4), (7, 7, 7), (3, 3, 3)),
    ((9, 3, 12), (7, 7, 7), (3, 3, 3)),
])
def test_window_geometry_matches_jax(dims, window, shift):
    ws, ss = port_swin.get_window_size_3d(dims, window, shift)
    assert (ws, ss) == jax_swin.get_window_size_3d(dims, window, shift)
    padded = tuple(d + (w - d % w) % w for d, w in zip(dims, ws))
    got = port_swin.window_region_ids_3d(padded, ws, ss)
    want = jax_swin.window_region_ids_3d(padded, ws, ss)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_swin.relative_position_index_3d(window),
                                  jax_swin.relative_position_index_3d(window))

    x = np.random.default_rng(0).standard_normal((2,) + padded + (5,)).astype(np.float32)
    win = port_swin.window_partition_3d(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_swin.window_partition_3d(jnp.asarray(x), ws)))
    back = port_swin.window_reverse_3d(win, ws, (2,) + padded)
    np.testing.assert_array_equal(back.numpy(), x)


def test_convert_matches_export_and_loads_strict():
    _, params = jax_swinunetr_params(1)
    sd = swinunetr_state_dict_from_jax(params)
    want = export_swinunetr(params)
    assert set(sd) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FS)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("jax_path", ["einsum", "pallas_interpret"])
def test_forward_matches_jax(jax_path, monkeypatch):
    if jax_path == "pallas_interpret":
        monkeypatch.setenv("ICL_TPU_PALLAS", "1")
        monkeypatch.setenv("ICL_TPU_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.setenv("ICL_TPU_PALLAS", "0")
    jax_model, params = jax_swinunetr_params(2)
    x = np.random.default_rng(3).standard_normal((2, PATCH, PATCH, PATCH, 1)).astype(np.float32)

    want = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, train=False))(params, jnp.asarray(x))
    want = np.moveaxis(np.asarray(want), -1, 1)  # NDHWC -> NCDHW
    with torch.no_grad():
        got = port_model(params)(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy()
    assert got.shape == want.shape == (2, 2, PATCH, PATCH, PATCH)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_registry_builds_swinunetr_for_both_keys_and_names_ported_keys():
    """`swinunetr` and the inference graph of `swinunetr_icl` are the same
    SwinUNETR; the training `swinunetr_icl` is SwinUNETRICL, whose
    state_dict without its ICL heads is that SwinUNETR's, weight for
    weight, from the same seed."""
    from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL, strip_icl_heads

    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    a = net_factory("swinunetr", 1, 2, device="cpu", generator=g(), feature_size=FS)
    b = net_factory("swinunetr_icl", 1, 2, device="cpu", generator=g(), feature_size=FS,
                    inference=True)
    c = net_factory("swinunetr_icl", 1, 2, device="cpu", generator=g(), feature_size=FS,
                    patch_size=PATCH)
    assert type(a) is type(b) is port_swin.SwinUNETR
    assert type(c) is SwinUNETRICL
    stripped = strip_icl_heads(c.state_dict())
    assert list(stripped) == list(a.state_dict())
    for sd in (b.state_dict(), stripped):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), sd.items()):
            assert ka == kb
            torch.testing.assert_close(va, vb, rtol=0, atol=0)
    attn = a.swinViT.layers1[0].blocks[0].attn
    np.testing.assert_array_equal(attn.relative_position_index.numpy(),
                                  jax_swin.relative_position_index_3d((7, 7, 7)))
    assert all(torch.isfinite(p).all() for p in a.parameters())
    with pytest.raises(KeyError, match="swinunetr_icl"):
        net_factory("vnet", 1, 2, device="cpu")  # a key neither package registers


def test_training_step_after_an_inference_mode_forward():
    """The region ids cached by a forward under `torch.inference_mode` (the
    sliding window's) can be saved for the backward of a later training
    forward in the same process, with and without recompute."""
    port_swin._region_ids_on.cache_clear()
    model = net_factory("swinunetr", 1, 2, device="cpu", generator=torch.Generator().manual_seed(3),
                        feature_size=FS)
    x = torch.randn(1, 1, PATCH, PATCH, PATCH, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        model.eval()(x)
    for remat in (False, True):
        model.train().remat = remat
        for layer in model.swinViT.modules():
            if isinstance(layer, port_swin.BasicLayer):
                layer.remat = remat
        model.zero_grad()
        model(x).square().mean().backward()
        grad = model.swinViT.layers1[0].blocks[1].attn.relative_position_bias_table.grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().max() > 0
