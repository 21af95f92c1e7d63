"""icl_tpu_torch's other reference losses, metrics and BraTS helpers
against the JAX package's: the 12 losses that no step calls
(`icl_tpu/losses.py:37, 49, 168-260`) on seeded channel-first inputs
against the JAX functions on the same values channel-last, value and (for
the differentiable ones) input gradient; the four metrics
(`icl_tpu/metrics.py:81-136`) on seeded maps, exactly; and
`center_crop_3d`, `random_noise_3d` (the same numpy draws: one seeded
generator each) and `create_onehot_label` (channel-first here,
channel-last in JAX) of `icl_tpu/data/brats.py:87-124`, exactly.
Tolerances: values and gradients in f32 within 1e-5 relative (plus 1e-7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu import metrics as jax_metrics
from icl_tpu.data import brats as jax_brats

from icl_tpu_torch import losses, metrics
from icl_tpu_torch.data import brats
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

B, C, H, W = 2, 4, 12, 10


def _cl(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _maps(seed: int, n: int = 3, softmax: bool = False, same: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = 1 if same else i + 1
        x = rng.standard_normal((B, C, H // f, W // f)).astype(np.float32)
        if softmax:
            x = np.exp(x) / np.exp(x).sum(1, keepdims=True)
        out.append(x)
    return out


def _labels(seed: int, shape=(B, H, W)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, C, shape).astype(np.int32)


def _check(port_fn, jax_fn, port_args, jax_args, grad: bool = True):
    """Value, and the gradient by the first argument (a tensor or a list of
    them) when `grad`."""
    def leaves(a):
        return a if isinstance(a, list) else [a]

    def as_torch(a):
        if isinstance(a, list):
            return [torch.from_numpy(x) for x in a]
        return torch.from_numpy(a) if isinstance(a, np.ndarray) else a

    tensors = [torch.tensor(x, requires_grad=grad) for x in leaves(port_args[0])]
    first = tensors if isinstance(port_args[0], list) else tensors[0]
    got = port_fn(first, *map(as_torch, port_args[1:]))
    want = jax_fn(*jax_args)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    if not grad:
        return
    got.backward()
    gfn = jax.grad(lambda a: jax_fn(a, *jax_args[1:]))
    want_grads = leaves(gfn(jax_args[0]))
    for t, wg, pa in zip(tensors, want_grads, leaves(port_args[0])):
        wg = np.asarray(wg)
        if wg.ndim == pa.ndim and wg.shape != pa.shape:
            wg = np.moveaxis(wg, -1, 1)
        got_grad = t.grad if t.grad is not None else torch.zeros_like(t)  # a scale left unused
        np.testing.assert_allclose(got_grad.numpy(), wg, rtol=1e-5, atol=1e-7)


def test_dice_losses():
    score, target = _maps(1, 1, softmax=True)[0], (_maps(2, 1)[0] > 0).astype(np.float32)
    for name in ("dice_loss_squared", "dice_loss_linear"):
        _check(getattr(losses, name), getattr(jax_losses, name), (score, target),
               (jnp.asarray(_cl(score)), jnp.asarray(_cl(target))))


@pytest.mark.parametrize("name", ["entropy_loss", "entropy_minimization"])
def test_entropies(name):
    p = _maps(3, 1, softmax=True)[0]
    args = (C,) if name == "entropy_loss" else ()
    _check(getattr(losses, name), getattr(jax_losses, name), (p, *args), (jnp.asarray(_cl(p)), *args))


def test_entropy_loss_map():
    p = _maps(4, 1, softmax=True)[0]
    got = losses.entropy_loss_map(torch.from_numpy(p)).numpy()
    want = np.moveaxis(np.asarray(jax_losses.entropy_loss_map(jnp.asarray(_cl(p)))), -1, 1)
    assert got.shape == (B, 1, H, W)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["symmetric_mse_loss", "cos_sim_loss", "compute_kl_loss"])
def test_losses_over_scales(name):
    """Three scales; the gradient by the second list (symmetric_mse_loss
    detaches its first, and compares every scale with its first: one size)."""
    same = name == "symmetric_mse_loss"
    a, b = _maps(5, same=same), _maps(6, same=same)
    port_fn, jax_fn = getattr(losses, name), getattr(jax_losses, name)
    _check(lambda y, x: port_fn(x, y), lambda y, x: jax_fn(x, y), (b, a),
           ([jnp.asarray(_cl(x)) for x in b], [jnp.asarray(_cl(x)) for x in a]))


@pytest.mark.parametrize("alpha", [None, [0.1, 0.2, 0.3, 0.4]])
def test_focal_loss(alpha):
    logits, y = _maps(7, 1)[0], _labels(8)
    _check(lambda x, lab: losses.focal_loss(x, lab, 2.0, alpha),
           lambda x, lab: jax_losses.focal_loss(x, lab, 2.0, None if alpha is None else jnp.asarray(alpha)),
           (logits, torch.from_numpy(y)), (jnp.asarray(_cl(logits)), jnp.asarray(y)))


def test_eam_loss():
    maps, y = _maps(9), _labels(10, (B, 16, 20))
    _check(lambda m, lab: losses.eam_loss(m, lab, (16, 20)),
           lambda m, lab: jax_losses.eam_loss(m, lab, (16, 20)),
           (maps, torch.from_numpy(y)), ([jnp.asarray(_cl(m)) for m in maps], jnp.asarray(y)))


def test_kd_loss():
    rng = np.random.default_rng(11)
    g1 = [rng.standard_normal((B, C, 8)).astype(np.float32) for _ in range(3)]
    g2 = [rng.standard_normal((B, C, 8)).astype(np.float32) for _ in range(3)]
    _check(losses.kd_loss, jax_losses.kd_loss, (g1, g2),
           ([jnp.asarray(x) for x in g1], [jnp.asarray(x) for x in g2]))


def test_softmax_kl_loss():
    a, b = _maps(12, 1)[0], _maps(13, 1)[0]
    _check(losses.softmax_kl_loss, jax_losses.softmax_kl_loss, (a, b),
           (jnp.asarray(_cl(a)), jnp.asarray(_cl(b))))
    want = torch.nn.functional.kl_div(torch.log_softmax(torch.from_numpy(a), 1),
                                      torch.softmax(torch.from_numpy(b), 1), reduction="sum") / a.size
    np.testing.assert_allclose(float(losses.softmax_kl_loss(torch.from_numpy(a), torch.from_numpy(b))),
                               float(want), rtol=1e-5)


def test_metrics_match_jax():
    rng = np.random.default_rng(14)
    pred = rng.integers(0, C, (3, 20, 20))
    gt = rng.integers(-1, C, (3, 20, 20))
    assert metrics.pixel_accuracy(pred, gt) == jax_metrics.pixel_accuracy(pred, gt)
    assert metrics.mean_iou(pred, gt, C + 2) == jax_metrics.mean_iou(pred, gt, C + 2)
    assert metrics.mean_iou(pred * 0 - 5, gt * 0 - 5, C) == jax_metrics.mean_iou(pred * 0 - 5, gt * 0 - 5, C) == 0.0
    for p, g in ((pred == 1, gt == 1), (pred == 9, gt == 9), (pred == 1, gt == 9)):
        assert metrics.jaccard_binary(p, g) == jax_metrics.jaccard_binary(p, g)
    soft_p, soft_g = rng.random((20, 20)), rng.random((20, 20))
    for p, g in ((soft_p, soft_g), (soft_p * 0, soft_g), (soft_p, soft_g * 0)):
        assert metrics.evaluate_seg(p, g) == jax_metrics.evaluate_seg(p, g)


@pytest.mark.parametrize("shape", [(20, 24, 18), (14, 30, 9)])
def test_brats_helpers_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    image = rng.standard_normal(shape).astype(np.float32)
    label = rng.integers(0, 3, shape).astype(np.uint8)
    out = (16, 16, 12)
    for got, want in zip(brats.center_crop_3d(image, label, out), jax_brats.center_crop_3d(image, label, out)):
        assert got.shape == out
        np.testing.assert_array_equal(got, want)
    got = brats.random_noise_3d(image, np.random.default_rng(3), 0.5, 0.2)
    want = jax_brats.random_noise_3d(image, np.random.default_rng(3), 0.5, 0.2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - image - 0.5).max() <= 0.4 + 1e-6
    onehot = brats.create_onehot_label(label, 3)
    assert onehot.shape == (3, *shape) and onehot.dtype == np.float32
    np.testing.assert_array_equal(onehot, np.moveaxis(jax_brats.create_onehot_label(label, 3), -1, 0))
