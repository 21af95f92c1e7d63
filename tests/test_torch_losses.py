"""icl_tpu_torch losses against `icl_tpu.losses`: values and gradients.

The port is channel-first, the JAX package channel-last; inputs are drawn
with numpy and transposed. Gradients are taken with respect to every
input that the loss does not detach, and the detached ones get none.
Tolerance 1e-5 absolute and relative: f32 sums of a few thousand terms
in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jl

from icl_tpu_torch import losses as pl
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

NCLS = 3
SPATIAL = (8, 6, 4)
TOL = dict(atol=1e-5, rtol=1e-5)


def _maps(seed, n=2, spatial=SPATIAL):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *spatial, NCLS)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


def _labels(seed, n=2, spatial=SPATIAL):
    return np.random.default_rng(seed).integers(0, NCLS, (n, *spatial)).astype(np.int32)


def _close(got: torch.Tensor, want, channel_last=False):
    w = np.asarray(want)
    if channel_last:
        w = np.moveaxis(w, -1, 1)
    np.testing.assert_allclose(got.detach().numpy(), w, **TOL)


@pytest.mark.parametrize("name", ["cross_entropy", "multiclass_dice", "multiclass_dice_weighted"])
def test_supervised_losses_and_grads_match_jax(name):
    x_cl, x_cf = _maps(0)
    y = _labels(1)
    if name == "cross_entropy":
        jfn = lambda a: jl.cross_entropy_loss(a, jnp.asarray(y))  # noqa: E731
        pfn = lambda a: pl.cross_entropy_loss(a, torch.from_numpy(y))  # noqa: E731
    else:
        weight = [0.2, 0.5, 1.3] if name.endswith("weighted") else None
        jfn = lambda a: jl.multiclass_dice_loss(a, jnp.asarray(y), NCLS, weight, softmax=True)  # noqa: E731
        pfn = lambda a: pl.multiclass_dice_loss(a, torch.from_numpy(y), NCLS, weight, softmax=True)  # noqa: E731
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x_cl))
    xt = torch.from_numpy(x_cf).requires_grad_(True)
    got = pfn(xt)
    got.backward()
    _close(got, want)
    _close(xt.grad, jgrad, channel_last=True)


def test_softmax_dice_loss_and_grads_match_jax():
    a_cl, a_cf = _maps(2)
    b_cl, b_cf = _maps(3)
    want, (ga, gb) = jax.value_and_grad(jl.softmax_dice_loss, argnums=(0, 1))(
        jnp.asarray(a_cl), jnp.asarray(b_cl))
    at, bt = (torch.from_numpy(t).requires_grad_(True) for t in (a_cf, b_cf))
    got = pl.softmax_dice_loss(at, bt)
    got.backward()
    _close(got, want)
    _close(at.grad, ga, channel_last=True)
    _close(bt.grad, gb, channel_last=True)


def test_softmax_mse_loss_detaches_targets_and_matches_jax():
    ins = [_maps(10 + i, spatial=(2 * i + 2,) * 3) for i in range(3)]
    tgts = [_maps(20 + i, spatial=(2 * i + 2,) * 3) for i in range(3)]
    want, (gi, gt) = jax.value_and_grad(jl.softmax_mse_loss, argnums=(0, 1))(
        [jnp.asarray(a) for a, _ in ins], [jnp.asarray(b) for b, _ in tgts])
    it = [torch.from_numpy(b).requires_grad_(True) for _, b in ins]
    tt = [torch.from_numpy(b).requires_grad_(True) for _, b in tgts]
    got = pl.softmax_mse_loss(it, tt)
    got.backward()
    _close(got, want)
    for t, g in zip(it, gi):
        _close(t.grad, g, channel_last=True)
    assert all(np.all(np.asarray(g) == 0) for g in gt)
    assert all(t.grad is None for t in tt)


def test_resize_maps_matches_jax_linear_resize():
    fm_cl, fm_cf = _maps(30, spatial=(2, 3, 4))
    want = jl._resize_maps(jnp.asarray(fm_cl), SPATIAL)
    _close(pl.resize_maps(torch.from_numpy(fm_cf), SPATIAL), want, channel_last=True)


def test_aux_loss_and_grads_match_jax():
    fms = [_maps(40 + i, spatial=s) for i, s in enumerate([(2, 2, 1), (4, 3, 2), (8, 6, 4)])]
    y = _labels(44)
    want, jgrads = jax.value_and_grad(
        lambda ms: jl.aux_loss(ms, jnp.asarray(y), NCLS, SPATIAL))([jnp.asarray(a) for a, _ in fms])
    ts = [torch.from_numpy(b).requires_grad_(True) for _, b in fms]
    got = pl.aux_loss(ts, torch.from_numpy(y), NCLS, SPATIAL)
    got.backward()
    _close(got, want)
    for t, g in zip(ts, jgrads):
        _close(t.grad, g, channel_last=True)


def test_pseudo_soft_loss_detaches_prediction_and_matches_jax():
    fms = [_maps(50 + i, spatial=s) for i, s in enumerate([(2, 2, 1), (4, 3, 2), (8, 6, 4)])]
    p_cl, p_cf = _maps(55)
    want, (jgrads, gp) = jax.value_and_grad(
        lambda ms, p: jl.pseudo_soft_loss(ms, p, SPATIAL), argnums=(0, 1))(
        [jnp.asarray(a) for a, _ in fms], jnp.asarray(p_cl))
    ts = [torch.from_numpy(b).requires_grad_(True) for _, b in fms]
    pt = torch.from_numpy(p_cf).requires_grad_(True)
    got = pl.pseudo_soft_loss(ts, pt, SPATIAL)
    got.backward()
    _close(got, want)
    for t, g in zip(ts, jgrads):
        _close(t.grad, g, channel_last=True)
    assert np.all(np.asarray(gp) == 0) and pt.grad is None
