"""icl_tpu_torch ICL heads and SwinUNETR-ICL against the JAX package's:
the weight carry (`utils/convert.py` against `export_icl_heads` and
`export_swinunetr`), one `InherentConsistent` head in both modes, the
whole SwinUNETR-ICL in train mode (its 5-tuple, with the two `sspa` calls
and with the fused pair, the latter also against the port's two calls)
and in inference mode (its logits), and the BatchNorm running stats after
a train-mode forward.

Small size: feature_size 12, patch 32^3 (head scales 2^3, 4^3, 8^3),
batch 4 with 2 labeled, JAX on its einsum attention path. Weights are
drawn with numpy and carried across. Drop path cannot draw the same
masks in both frameworks, so it is off on both sides: the port's rates
are set to 0 and the JAX `DropPath.__call__` is patched to the identity
(exactly rate 0). The backbone has no drop path.

Tolerances: f32 on both sides with the JAX matmuls at "highest"; 1e-4
absolute and relative on logits and maps (sums of a few thousand terms
in another order), 1e-5 on the BatchNorm stats; the fused pair against
the two calls 2e-5 (tests/test_torch_unet2d.py's rule).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models import layers as jax_layers
from icl_tpu.models.icl import InherentConsistent as JaxInherentConsistent
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.utils.torch_import import export_icl_heads, export_swinunetr

from icl_tpu_torch.models import layers as port_layers
from icl_tpu_torch.models.icl import InherentConsistent
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL, strip_icl_heads
from icl_tpu_torch.utils.convert import icl_head_state_dict_from_jax, swinunetr_icl_state_dict_from_jax
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

FS, PATCH, NCLS, LABELED_BS = 12, 32, 2, 2
ATOL = RTOL = 1e-4


@pytest.fixture
def no_drop_path(monkeypatch):
    monkeypatch.setattr(jax_layers.DropPath, "__call__", lambda self, x, train: x)


def draw_tree(shapes, seed: int):
    """Every leaf drawn with numpy: kernels ~ N(0, 1/fan_in), norm scales
    ~ 1 + N(0, 0.1^2), bias tables ~ N(0, 0.5^2), BN running means ~
    N(0, 0.1^2) and variances ~ U(0.5, 1.5), everything else ~ N(0, 0.1^2)."""
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
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.cache
def _jax_icl_model_and_shapes(fuse: bool = False):
    model = jax_net_factory("swinunetr_icl", 1, NCLS, patch_size=PATCH, feature_size=FS,
                            fuse_sspa_pair=fuse)
    x = jnp.zeros((LABELED_BS, PATCH, PATCH, PATCH, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return model, shapes


def jax_icl_variables(seed: int, fuse: bool = False):
    """(JAX SwinUNETRICL module, params, batch_stats) drawn with numpy."""
    model, shapes = _jax_icl_model_and_shapes(fuse)
    return model, draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)


def no_port_drop_path(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, port_layers.DropPath):
            m.rate = 0.0
    return model


def port_icl_model(params, batch_stats, remat: bool = False, fuse: bool = False) -> SwinUNETRICL:
    model = net_factory("swinunetr_icl", 1, NCLS, device="cpu", feature_size=FS, patch_size=PATCH,
                        remat=remat, fuse_sspa_pair=fuse)
    model.load_state_dict(swinunetr_icl_state_dict_from_jax(params, batch_stats), strict=True)
    return no_port_drop_path(model)


def batch(seed: int, n: int = 2 * LABELED_BS):
    """A seeded batch: NDHWC image for JAX, NCDHW for the port, labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, PATCH, PATCH, PATCH, 1)).astype(np.float32)
    y = (rng.random((n, PATCH, PATCH, PATCH)) < 0.3).astype(np.int32)
    return x, np.moveaxis(x, -1, 1).copy(), y


def cl2cf(a) -> np.ndarray:
    """channel-last JAX map -> channel-first numpy."""
    return np.moveaxis(np.asarray(a), -1, 1)


def expected_running_var(var0, jax_var, n: int, updates: int):
    """torch's running_var after `updates` train-mode passes, from flax's:
    torch takes the unbiased batch variance, flax the biased one, so the
    part that comes from the batches differs by n / (n - 1)."""
    decay = 0.9**updates
    return decay * var0 + (jax_var - decay * var0) * n / (n - 1)


def test_convert_icl_matches_export_and_loads_strict():
    _, params, bs = jax_icl_variables(0)
    sd = swinunetr_icl_state_dict_from_jax(params, bs)
    want = dict(export_swinunetr(params["backbone"]))
    for k, v in export_icl_heads(params, bs).items():
        want[k.replace(".guided_Q", ".guide_Q")] = v
    counts = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - counts == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    model = net_factory("swinunetr_icl", 1, NCLS, device="cpu", feature_size=FS, patch_size=PATCH)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    backbone = net_factory("swinunetr_icl", 1, NCLS, device="cpu", feature_size=FS, inference=True)
    backbone.load_state_dict(strip_icl_heads(sd), strict=True)


@pytest.mark.parametrize("modal", ["labeled", "unlabeled"])
def test_inherent_consistent_head_matches_jax(modal, no_drop_path):
    """One 3D head (in_chans 48/24/12, heads 24/12/6 so head dim 2, scales
    2^3/4^3/8^3), train mode: the class maps, the batch-mean queries and
    the BatchNorm running stats."""
    kw = dict(in_chans=(48, 24, 12), num_classes=NCLS, num_heads=(24, 12, 6),
              input_resolution=(2, 4, 8), spatial_dims=3)
    jax_head = JaxInherentConsistent(**kw)
    rng = np.random.default_rng(11)
    feats = [rng.standard_normal((3, r, r, r, c)).astype(np.float32)
             for r, c in zip((2, 4, 8), (48, 24, 12))]
    queries = [rng.standard_normal((1, NCLS, c)).astype(np.float32) for c in (48, 24, 12)]
    jfeats = [jnp.asarray(f) for f in feats]
    jq = [jnp.asarray(q) for q in queries] if modal == "unlabeled" else None
    shapes = jax.eval_shape(lambda: jax_head.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jfeats, jq,
        modal, train=True))
    params, bs = draw_tree(shapes["params"], 12), draw_tree(shapes["batch_stats"], 13)
    (fm_j, qs_j), mut = jax_head.apply({"params": params, "batch_stats": bs}, jfeats, jq, modal,
                                       train=True, mutable=["batch_stats"])

    head = InherentConsistent(**kw)
    head.load_state_dict(icl_head_state_dict_from_jax(params, bs), strict=True)
    no_port_drop_path(head).train()
    fm_p, qs_p = head([torch.from_numpy(cl2cf(f)) for f in feats],
                      [torch.from_numpy(q) for q in queries] if modal == "unlabeled" else None,
                      modal=modal)
    for got, want in zip(fm_p, fm_j):
        np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    for got, want in zip(qs_p, qs_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    sd = head.state_dict()
    for i, r in enumerate((2, 4, 8)):
        for bn in ("bn_depth", "bn_point"):
            new = mut["batch_stats"][f"attn_conv0_{i}"][bn]["BatchNorm_0"]
            old = bs[f"attn_conv0_{i}"][bn]["BatchNorm_0"]
            key = f"attn_convs0.{i}.block.{bn}"
            np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(), np.asarray(new["mean"]),
                                       atol=1e-5, rtol=1e-5)
            want_var = expected_running_var(np.asarray(old["var"]), np.asarray(new["var"]),
                                            n=3 * NCLS * r**3, updates=1)
            np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(), want_var, atol=1e-5, rtol=1e-5)
            assert int(sd[f"{key}.num_batches_tracked"]) == 1


def _train_forward_against_jax(fuse: bool):
    """The port's 5-tuple and model after one train-mode forward, held
    against the JAX model's with the same `fuse_sspa_pair`."""
    jax_model, params, bs = jax_icl_variables(1, fuse)
    x, xt, _ = batch(2)
    outs_j, mut = jax.jit(lambda p, b, xl, xu: jax_model.apply(
        {"params": p, "batch_stats": b}, xl, xu, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(params, bs, jnp.asarray(x[:LABELED_BS]),
                                                   jnp.asarray(x[LABELED_BS:]))
    model = port_icl_model(params, bs, fuse=fuse).train()
    outs_p = model(torch.from_numpy(xt[:LABELED_BS]), torch.from_numpy(xt[LABELED_BS:]))
    assert len(outs_p) == 5
    for got, want in zip(outs_p[:2], outs_j[:2]):
        assert got.shape == (LABELED_BS, NCLS, PATCH, PATCH, PATCH)
        np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    for maps_p, maps_j in zip(outs_p[2:], outs_j[2:]):
        assert [m.shape[2:] for m in maps_p] == [(2, 2, 2), (4, 4, 4), (8, 8, 8)]
        for got, want in zip(maps_p, maps_j):
            np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    sd = model.state_dict()
    for head, updates in (("sspa", 2), ("uscl", 1)):
        for i, r in enumerate((2, 4, 8)):
            node = mut["batch_stats"][head][f"attn_conv0_{i}"]["bn_point"]["BatchNorm_0"]
            old = bs[head][f"attn_conv0_{i}"]["bn_point"]["BatchNorm_0"]
            key = f"{head}.attn_convs0.{i}.block.bn_point"
            np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(), np.asarray(node["mean"]),
                                       atol=1e-5, rtol=1e-5)
            want_var = expected_running_var(np.asarray(old["var"]), np.asarray(node["var"]),
                                            n=LABELED_BS * NCLS * r**3, updates=updates)
            np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(), want_var, atol=1e-5, rtol=1e-5)
    return outs_p, model, (params, bs, xt)


def test_swinunetr_icl_train_forward_matches_jax(no_drop_path):
    """The 5-tuple (logits lab/unlab, maps lab/unlab/consis) of one
    train-mode forward, and the running stats of both heads after it:
    sspa runs twice (labeled, then unlabeled), uscl once."""
    _train_forward_against_jax(fuse=False)


def test_swinunetr_icl_fused_pair_matches_jax_and_two_calls(no_drop_path):
    """`fuse_sspa_pair`: the 5-tuple and the running stats against the
    JAX model's fused pair, and against the port's two calls from the
    same weights (every output and every state entry, 2e-5)."""
    fused, model, (params, bs, xt) = _train_forward_against_jax(fuse=True)
    two = port_icl_model(params, bs).train()
    want = two(torch.from_numpy(xt[:LABELED_BS]), torch.from_numpy(xt[LABELED_BS:]))
    for got, ref in zip(fused[:2], want[:2]):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=2e-5)
    for maps_f, maps_t in zip(fused[2:], want[2:]):
        for got, ref in zip(maps_f, maps_t):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=2e-5)
    ref_sd = two.state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2e-5, rtol=2e-5, err_msg=k)


def test_swinunetr_icl_inference_logits_match_jax():
    jax_model, params, bs = jax_icl_variables(3)
    x, xt, _ = batch(4, n=2)
    want = jax_model.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), train=False,
                           inference=True)
    model = port_icl_model(params, bs).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xt), inference=True)
        assert torch.equal(got, model(torch.from_numpy(xt)))
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)


def test_drop_path_is_per_sample_and_identity_in_eval():
    x = torch.randn(64, 3, 4)
    dp = port_layers.DropPath(0.25, generator=torch.Generator().manual_seed(0))
    out = dp(x)
    kept = (out != 0).flatten(1).all(1)
    dropped = (out == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and 0 < int(kept.sum()) < 64
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)
    again = port_layers.DropPath(0.25, generator=torch.Generator().manual_seed(0))(x)
    assert torch.equal(out, again)
    assert dp.eval()(x) is x
    assert port_layers.DropPath(0.0).train()(x) is x
