"""icl_tpu_torch's 3D U-Net and U-Net-ICL against the JAX package's: the
half-pixel trilinear upsample at the edges, the weight carry
(`utils/convert.py` against `export_unet3d` and `export_icl_unet3d`, key
for key and bit for bit, loaded strictly), the U-Net's logits in eval
mode, the whole U-Net-ICL in train mode (its 5-tuple, with and without
the fused `sspa` pair) with the heads' BatchNorm running stats, its
inference logits, and the kaiming init of a freshly built model.

Small size: the JAX default filters (16, 32, 64, 128, 256), patch 32^3
(ICL scales 2^3, 4^3, 8^3: `mlp2` 512^2 at the finest), 2 classes, batch
2 labeled + 2 unlabeled. Weights are drawn with numpy
(`test_torch_icl.draw_tree`) and carried across. Dropout and drop path
cannot draw the same masks in both frameworks, so they are off on both
sides: `zero_stochastic` in the port, flax's `Dropout` and the JAX
`DropPath` patched to the identity (exactly rate 0).

Tolerances: f32 on both sides, JAX matmuls at "highest". The upsample:
1e-6 absolute (two f32 taps per axis summed in another order). Logits
and ICL maps: 1e-4 absolute and relative (sums of up to ~10^4 terms in
another order through 19 conv layers). BatchNorm running means 1e-5
absolute; running variances 1e-5 absolute after the n / (n - 1) factor
(torch updates with the unbiased batch variance, flax with the biased
one).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from icl_tpu.models import layers as jax_layers
from icl_tpu.models.unet3d import UNet3D as JaxUNet3D
from icl_tpu.models.unet3d_icl import UNet3DICL as JaxUNet3DICL
from icl_tpu.utils.torch_import import export_icl_unet3d, export_unet3d

from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swinunetr_icl import strip_icl_heads
from icl_tpu_torch.models.unet3d import KaimingConv3d, UNet3D, UpBlock3D
from icl_tpu_torch.models.unet3d_icl import UNet3DICL
from icl_tpu_torch.utils.convert import icl_unet3d_state_dict_from_jax, unet3d_state_dict_from_jax
from test_torch_icl import cl2cf, draw_tree
from test_torch_unet2d import assert_running_stats, bn_batch_sizes
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

PATCH, NCLS, LABELED_BS = 32, 2, 2
ATOL = RTOL = 1e-4


@pytest.fixture
def no_stochastic_jax(monkeypatch):
    """flax's Dropout and the JAX DropPath as the identity."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jax_layers.DropPath, "__call__", lambda self, x, train: x)


@functools.cache
def _jax_shapes(fuse: bool = False, patch: int = PATCH):
    model = JaxUNet3DICL(1, NCLS, patch_size=patch, fuse_sspa_pair=fuse)
    x = jnp.zeros((LABELED_BS, patch, patch, patch, 1))
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))


def jax_variables(seed: int, fuse: bool = False, patch: int = PATCH):
    """(JAX UNet3DICL at patch side `patch`, params, batch_stats) drawn
    with numpy."""
    model, shapes = _jax_shapes(fuse, patch)
    return model, draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)


def port_model(params, batch_stats, fuse: bool = False, remat: bool = False) -> UNet3DICL:
    model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=PATCH, fuse_sspa_pair=fuse,
                        zero_stochastic=True, remat=remat)
    model.load_state_dict(icl_unet3d_state_dict_from_jax(params, batch_stats), strict=True)
    return model


def images(seed: int, n: int = 2 * LABELED_BS, patch: int = PATCH):
    """A seeded batch: NDHWC for JAX, NCDHW for the port."""
    x = np.random.default_rng(seed).standard_normal((n, patch, patch, patch, 1)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 2, 1, 3, 2)])
def test_upsample_matches_jax_resize_at_the_edges(shape):
    """UpBlock3D's upsample against `jax.image.resize(..., "linear")`, every
    voxel (the edge voxels sample outside the input on the half-pixel
    grid: both clamp to the edge), a size-1 axis included."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    b, c, d, h, w = shape
    want = cl2cf(jax.image.resize(jnp.asarray(np.moveaxis(x, 1, -1)), (b, 2 * d, 2 * h, 2 * w, c),
                                  method="linear"))
    block = UpBlock3D(2 * c, 1)
    captured = []
    block.conv.register_forward_pre_hook(lambda mod, inp: captured.append(inp[0]))
    with torch.no_grad():
        block(torch.zeros(b, c, 2 * d, 2 * h, 2 * w), torch.from_numpy(x))
    got = captured[0][:, c:].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_convert_matches_export_and_loads_strict():
    _, params, bs = jax_variables(0)
    sd = icl_unet3d_state_dict_from_jax(params, bs)
    want = export_icl_unet3d(params, bs)
    counts = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - counts == set(want)
    assert "conv1.conv1.0.weight" in want and "up_concat4.conv.conv2.0.bias" in want
    assert "final.weight" in want and not any(k.startswith("backbone.") for k in want)
    for key, value in want.items():
        assert sd[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=PATCH)
    assert set(model.state_dict()) == set(sd)
    # the export as it is (torch's BatchNorm sets the batch counts it lacks to 0)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in want.items()}, strict=True)
    model.load_state_dict(sd, strict=True)
    backbone = unet3d_state_dict_from_jax(params["backbone"])
    assert set(backbone) == set(export_unet3d(params, wrapped_in_backbone=True))
    stripped = strip_icl_heads(sd)
    assert set(stripped) == set(backbone)
    assert all(torch.equal(stripped[k], backbone[k]) for k in backbone)
    plain = net_factory("unet_3D_icl", 1, NCLS, device="cpu", inference=True)
    assert type(plain) is UNet3D
    plain.load_state_dict(stripped, strict=True)


def test_unet3d_logits_match_jax():
    """The plain U-Net 3D in eval mode, weights from `export_unet3d`
    loaded strictly as they are."""
    _, params, _ = jax_variables(1)
    params = params["backbone"]
    x, xt = images(2, n=2)
    want = jax.jit(lambda v, x: JaxUNet3D(1, NCLS).apply(v, x, train=False))(
        {"params": params}, jnp.asarray(x))
    model = net_factory("unet_3D", 1, NCLS, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in export_unet3d(params).items()},
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fuse", [False, True], ids=["two_calls", "fused_pair"])
def test_unet3d_icl_train_mode_and_batch_stats_match_jax(fuse, no_stochastic_jax):
    jax_model, params, bs = jax_variables(3, fuse)
    x, xt = images(4)
    outs_j, mut = jax.jit(lambda v, a, b: jax_model.apply(v, a, b, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x[:LABELED_BS]), jnp.asarray(x[LABELED_BS:]))
    model = port_model(params, bs, fuse).train()
    sizes = bn_batch_sizes(model)
    xt = torch.from_numpy(xt)
    with torch.no_grad():
        outs_p = model(xt[:LABELED_BS], xt[LABELED_BS:])
    assert len(outs_p) == 5
    for i in (0, 1):
        np.testing.assert_allclose(outs_p[i].numpy(), cl2cf(outs_j[i]), atol=ATOL, rtol=RTOL,
                                   err_msg=f"logits {i}")
    for i in (2, 3, 4):
        assert len(outs_p[i]) == 3
        for s, (got, want) in enumerate(zip(outs_p[i], outs_j[i])):
            np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL,
                                       err_msg=f"maps {i} scale {s}")
    new = icl_unet3d_state_dict_from_jax(params, mut["batch_stats"])
    assert_running_stats(model, sizes, icl_unet3d_state_dict_from_jax(params, bs), new)
    # only the heads hold BatchNorms: sspa's saw two calls, uscl's one
    assert sizes and all(n.startswith(("sspa.", "uscl.")) for n in sizes)
    assert {len(sizes[n]) for n in sizes if n.startswith("sspa")} == {2}
    assert {len(sizes[n]) for n in sizes if n.startswith("uscl")} == {1}


def test_unet3d_icl_inference_logits_match_jax():
    jax_model, params, bs = jax_variables(5)
    x, xt = images(6, n=3)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False, inference=True))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    model = port_model(params, bs).eval()
    xt = torch.from_numpy(xt)
    with torch.no_grad():
        got = model(xt, inference=True)
        alone = model(xt)
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, alone)


def test_fresh_model_has_the_kaiming_init_and_seeded_backbone():
    """Every backbone conv: weights of std sqrt(2 / fan_in), biases within
    1/sqrt(fan_in); the same seed gives the same backbone with and without
    the heads."""
    gen = functools.partial(torch.Generator().manual_seed, 7)
    model = net_factory("unet_3D_icl", 1, NCLS, device="cpu", patch_size=PATCH, generator=gen())
    plain = net_factory("unet_3D", 1, NCLS, device="cpu", generator=gen())
    convs = [m for m in model.modules() if isinstance(m, KaimingConv3d)]
    assert len(convs) == 19
    for m in convs:
        fan_in = math.prod(m.weight.shape[1:])
        if m.weight.numel() >= 1000:
            assert abs(float(m.weight.detach().std()) / math.sqrt(2.0 / fan_in) - 1) < 0.1
        assert float(m.bias.detach().abs().max()) <= 1 / math.sqrt(fan_in)
    for k, v in plain.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
