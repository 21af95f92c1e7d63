"""icl_tpu_torch BraTS sliding-window evaluation against the JAX package's:
label maps, per-case (dice, hd95), the metrics, and the eval CLI on the
CPU with a synthetic h5 dataset.

The volume (40 x 36 x 28, patch 32^3, stride 16) needs padding in z and
overlap in x and y. Label maps must agree except at voxels whose top-2
stitched-probability margin is under 1e-5, where f32 rounding may pick
either class.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icl_tpu.eval import infer3d as jax_infer
from icl_tpu.metrics import calculate_metric_percase as jax_metric

from icl_tpu_torch.eval import infer3d
from icl_tpu_torch.metrics import calculate_metric_percase
from test_torch_swinunetr import PATCH, jax_swinunetr_params, port_model
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

PATCH3 = (PATCH,) * 3
STRIDE = 16


def _jax_stitched_probs(probs_fn, variables, image):
    """Mean-stitched probabilities [W, H, D, C] of the JAX protocol on a
    volume that needs no padding in x, y (only used to read margins)."""
    w, h, d = image.shape
    dp = max(PATCH - d, 0)
    padded = np.pad(image, ((0, 0), (0, 0), (dp // 2, dp - dp // 2)))
    score = np.zeros(padded.shape + (2,), np.float32)
    cnt = np.zeros(padded.shape, np.float32)
    starts = [(x, y, z) for x in jax_infer._grid_starts(padded.shape[0], PATCH, STRIDE)
              for y in jax_infer._grid_starts(padded.shape[1], PATCH, STRIDE)
              for z in jax_infer._grid_starts(padded.shape[2], PATCH, STRIDE)]
    for x, y, z in starts:
        patch = padded[None, x:x + PATCH, y:y + PATCH, z:z + PATCH, None].repeat(4, 0)
        score[x:x + PATCH, y:y + PATCH, z:z + PATCH] += np.asarray(probs_fn(variables, jnp.asarray(patch)))[0]
        cnt[x:x + PATCH, y:y + PATCH, z:z + PATCH] += 1
    return (score / cnt[..., None])[:, :, dp // 2:dp // 2 + d]


@pytest.fixture(scope="module")
def models():
    jax_model, params = jax_swinunetr_params(4)
    return (jax_infer.make_patch_predictor(jax_model, PATCH3, sw_batch=4), {"params": params},
            infer3d.make_patch_predictor(port_model(params)))


def _cases(n):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        image = rng.standard_normal((40, 36, 28)).astype(np.float32)
        label = (image > 0.8).astype(np.uint8)
        out.append({"image": image, "label": label})
    return out


def _label_maps_agree(models, image) -> bool:
    """Both label maps of `image`; asserts that they differ only at
    near-tie voxels. True when they are equal."""
    jax_probs, variables, port_probs = models
    want = jax_infer.sliding_window_predict(jax_probs, variables, image, 2, PATCH3, STRIDE, STRIDE, 4)
    got = infer3d.sliding_window_predict(port_probs, image, 2, PATCH3, STRIDE, STRIDE, 4, device="cpu")
    assert got.shape == want.shape == image.shape and got.dtype == np.uint8
    assert 0 < want.sum() < want.size  # both classes present
    differ = got != want
    if differ.any():
        probs = _jax_stitched_probs(jax_probs, variables, image)
        top2 = np.sort(probs, axis=-1)[..., -2:]
        assert np.all((top2[..., 1] - top2[..., 0])[differ] < 1e-5)
    return not differ.any()


def test_sliding_window_matches_jax(models):
    _label_maps_agree(models, _cases(1)[0]["image"])


def test_evaluate_brats_cases_matches_jax(models):
    """Same (dice, hd95) per case; where a near tie flipped a voxel (see
    the module docstring) dice may move in the 4th digit."""
    jax_probs, variables, port_probs = models
    cases = _cases(2)
    want = jax_infer.evaluate_brats_cases(jax_probs, variables, cases, 2, PATCH3, STRIDE, STRIDE, 4)
    got = infer3d.evaluate_brats_cases(port_probs, cases, 2, PATCH3, STRIDE, STRIDE, 4, device="cpu")
    assert len(got) == len(want) == 1 and len(got[0]) == len(cases)
    for case, g, w in zip(cases, got[0], want[0]):
        exact = _label_maps_agree(models, case["image"])
        np.testing.assert_allclose(g, w, rtol=1e-6 if exact else 1e-3)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    a = rng.random((20, 18, 16)) > 0.7
    b = np.roll(a, 2, axis=0) | (rng.random(a.shape) > 0.95)
    empty = np.zeros_like(a)
    for pred, gt in ((a, b), (a, empty), (empty, b), (empty, empty)):
        assert calculate_metric_percase(pred, gt) == jax_metric(pred, gt)


def test_cli_evaluates_synthetic_brats_on_cpu(tmp_path):
    h5py = pytest.importorskip("h5py")
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.scripts import test_3D_BraTS

    (tmp_path / "data").mkdir()
    rng = np.random.default_rng(7)
    names = ["case_a", "case_b"]
    for name in names:
        with h5py.File(tmp_path / "data" / f"{name}.h5", "w") as f:
            image = rng.standard_normal((36, 34, 30)).astype(np.float32)
            f["image"] = image
            f["label"] = (image > 1.0).astype(np.uint8)
    (tmp_path / "val_test.txt").write_text("\n".join(names) + "\n")
    model = net_factory("swinunetr_icl", 1, 2, device="cpu", generator=torch.Generator().manual_seed(8),
                        inference=True)
    ckpt = tmp_path / "model_best.pth"
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, ckpt)

    total = test_3D_BraTS.main(["--root_path", str(tmp_path), "--checkpoint", str(ckpt),
                                "--patch_size", "32", "32", "32", "--stride_xy", "32",
                                "--stride_z", "32", "--device", "cpu"])
    assert total.shape == (2,) and np.all(np.isfinite(total))
    assert 0.0 <= total[0] <= 1.0
