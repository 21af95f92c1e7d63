"""icl_tpu_torch's U-Net variants and the 2D/3D inference tails against the
JAX package's: UNetCCT, UNetURPC and UNetDS carried over by the new
converters and run in eval mode, and in train mode with the perturbations
and dropout the identity on both sides (outputs and the BatchNorm
running stats); the perturbations' ranges; torch's "nearest" upsampling
against `jax.image.resize` "nearest" at the heads' integer factors;
`generate_pseudo_labels`' files against the JAX package's; and
`make_fused_sliding_window` against the port's `sliding_window_predict`
(softmax and logits, the AMOS bf16-rounded input).

Small size as `test_torch_unet2d.py`: the default U-Net features, 64^2,
4 classes, batch 2; weights drawn with numpy and carried across. f32 on
both sides, JAX matmuls at "highest". Tolerances: outputs 1e-4 absolute
and relative (`test_torch_unet2d.py`'s); running means 1e-5, running
variances 1e-5 after the n / (n - 1) factor; the upsampling, the files
and the label maps equal.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.eval.infer2d import generate_pseudo_labels as jax_generate_pseudo_labels
from icl_tpu.models import unet2d_variants as jax_variants

from icl_tpu_torch.eval.infer2d import generate_pseudo_labels
from icl_tpu_torch.eval.infer3d import (make_fused_sliding_window, make_patch_predictor,
                                        sliding_window_predict)
from icl_tpu_torch.models import unet2d_variants
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.utils.convert import unet_cct_state_dict_from_jax, unet_ds_state_dict_from_jax
from test_torch_icl import cl2cf, draw_tree
from test_torch_unet2d import assert_running_stats, bn_batch_sizes
from test_torch_unet3d import no_stochastic_jax  # noqa: F401  (a fixture)

NCLS, SIDE, BATCH = 4, 64, 2
ATOL = RTOL = 1e-4
JAX_CLASSES = {"unet_cct": jax_variants.UNetCCT, "unet_urpc": jax_variants.UNetURPC,
               "unet_ds": jax_variants.UNetDS}
CONVERT = {"unet_cct": unet_cct_state_dict_from_jax, "unet_urpc": unet_ds_state_dict_from_jax,
           "unet_ds": unet_ds_state_dict_from_jax}


@functools.cache
def _jax_shapes(key: str):
    model = JAX_CLASSES[key](1, NCLS)
    x = jnp.zeros((BATCH, SIDE, SIDE, 1))
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, train=True))


def _models(key: str, seed: int):
    jax_model, shapes = _jax_shapes(key)
    params, bs = draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)
    old = CONVERT[key](params, bs)
    model = net_factory(key, 1, NCLS, device="cpu")
    model.load_state_dict(old, strict=True)
    return jax_model, params, bs, model, old


def _images(seed: int):
    x = np.random.default_rng(seed).standard_normal((BATCH, SIDE, SIDE, 1)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("key", list(JAX_CLASSES))
def test_variant_eval_outputs_match_jax(key):
    jax_model, params, bs, model, _ = _models(key, 10)
    x, xt = _images(11)
    want = jax.jit(lambda v, a: jax_model.apply(v, a, train=False))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xt))
    want, got = _as_tuple(want), _as_tuple(got)
    assert len(got) == len(want) == (1 if key == "unet_cct" else 4)
    for g, w in zip(got, want):
        assert g.shape == (BATCH, NCLS, SIDE, SIDE)
        np.testing.assert_allclose(g.numpy(), cl2cf(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("key", list(JAX_CLASSES))
def test_variant_train_outputs_and_batch_stats_match_jax(key, no_stochastic_jax, monkeypatch):
    """Train mode with the perturbations and the encoder's dropout the
    identity on both sides: every output and the running stats."""
    for name in ("feature_dropout", "feature_noise", "dropout_perturb"):
        monkeypatch.setattr(jax_variants, name, lambda x, rng, *a: x)
    jax_model, params, bs, model, old = _models(key, 20)
    x, xt = _images(21)
    want, mut = jax.jit(lambda v, a: jax_model.apply(v, a, train=True, mutable=["batch_stats"],
                                                     rngs={"dropout": jax.random.PRNGKey(0)}))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if hasattr(m, "perturb"):
            m.perturb = False
    model.train()
    sizes = bn_batch_sizes(model)
    with torch.no_grad():
        got = model(torch.from_numpy(xt))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), cl2cf(w), atol=ATOL, rtol=RTOL)
    assert_running_stats(model, sizes, old, CONVERT[key](params, mut["batch_stats"]))


def test_perturbations_ranges():
    x = torch.rand(3, 8, 16, 16, generator=torch.Generator().manual_seed(1)) + 0.5
    g = torch.Generator().manual_seed(0)
    noisy = unet2d_variants.feature_noise(x, g)
    ratio = noisy / x - 1
    assert ratio.abs().max() <= 0.3 and ratio.abs().max() > 0.25
    assert torch.allclose(ratio[0], ratio[2], atol=1e-6)  # shared across the batch
    dropped = unet2d_variants.dropout_perturb(x, g, 0.3)
    kept = dropped != 0
    assert torch.allclose(dropped[kept], x[kept] / 0.7)
    assert 0.25 < 1 - kept.float().mean() < 0.35
    out = unet2d_variants.feature_dropout(x, g)
    attention = x.mean(1, keepdim=True)
    zeroed = (out == 0).all(1, keepdim=True)
    assert torch.equal(out, x * (~zeroed))
    peak = attention.flatten(1).amax(1).view(-1, 1, 1, 1)
    # the zeroed positions are those at or above one fraction in [0.7, 0.9]
    # of each sample's peak
    frac = attention / peak
    assert bool(zeroed.any()) and bool((~zeroed).any())
    assert frac[zeroed].min() >= 0.7 and frac[~zeroed].max() < 0.9
    assert frac[~zeroed].max() < frac[zeroed].min()
    again = torch.Generator().manual_seed(0)
    assert torch.equal(unet2d_variants.feature_noise(x, again), noisy)


@pytest.mark.parametrize("side,factor", [(8, 2), (8, 4), (4, 8), (5, 3)])
def test_nearest_upsampling_matches_jax(side, factor):
    x = np.random.default_rng(side * factor).standard_normal((2, 3, side, side + 1)).astype(np.float32)
    out = (side * factor, (side + 1) * factor)
    got = torch.nn.functional.interpolate(torch.from_numpy(x), size=out, mode="nearest").numpy()
    want = jax.image.resize(jnp.asarray(np.moveaxis(x, 1, -1)), (2, *out, 3), method="nearest")
    np.testing.assert_array_equal(got, cl2cf(want))


def test_pseudo_label_files_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    dataset = [{"image": rng.standard_normal((3, 20, 24)).astype(np.float32), "case": f"patient{i:03d}"}
               for i in range(2)]

    def labels(image):
        return np.digitize(image, [-0.5, 0.0, 0.5]).astype(np.uint8)

    n = generate_pseudo_labels(labels, dataset, str(tmp_path / "port"))
    n_jax = jax_generate_pseudo_labels(lambda v, image: labels(image), None, dataset,
                                       str(tmp_path / "jax"))
    assert n == n_jax == 6
    names = sorted(p.name for p in (tmp_path / "port" / "slices_iter1").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "slices_iter1").iterdir())
    assert "patient001_slice_3.h5" in names
    for name in names:
        with h5py.File(tmp_path / "port" / "slices_iter1" / name) as f, \
                h5py.File(tmp_path / "jax" / "slices_iter1" / name) as g:
            for key in ("image", "label"):
                assert f[key].dtype == g[key].dtype and f[key].compression == "gzip"
                np.testing.assert_array_equal(f[key][:], g[key][:])


@pytest.mark.parametrize("softmax,dtype", [(True, None), (False, torch.bfloat16)],
                         ids=["brats_softmax", "amos_logits_bf16_input"])
def test_fused_sliding_window_equals_the_sliding_window(softmax, dtype):
    model = net_factory("unet_3D", 1, 3, device="cpu", generator=torch.Generator().manual_seed(4))
    model.eval()
    image = np.random.default_rng(5).standard_normal((40, 28, 34)).astype(np.float32)
    fused = make_fused_sliding_window(model, 3, (32, 32, 32), sw_batch=3, apply_softmax=softmax,
                                      dtype=dtype, device="cpu")
    plain = make_patch_predictor(model, apply_softmax=softmax, dtype=dtype)
    for stride in (8, 24):
        got = fused(image, stride, stride)
        want = sliding_window_predict(plain, image, 3, (32, 32, 32), stride, stride, sw_batch=3,
                                      device="cpu")
        assert got.shape == image.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
