"""The dense-mask form of icl_tpu_torch's fused window attention (the
counterpart of `_kernel_masked` and of the dense-mask branch of
`_fused_attention_bwd`) against the JAX package's: the plain forward
against `window_attention_fused(..., mask, interpret=True)` (the Pallas
kernel in interpret mode) and `window_attention_reference`; the plain
backward against `jax.vjp` of both; and an f64 `gradcheck` of
`WindowAttentionFn` with a mask. The CUDA kernels are held against the
plain versions on the card, in `test_torch_window_attention_card.py`.

Masks: the Swin-UNet 2D shift mask (0 / -100) of a 14^2 grid with window 7
(N = 49) and of a 24^2 grid with window 12 (N = 144), and a random dense
mask, since the kernels take any additive mask. Head dims 16 and 32, and
4, 8, 12 and 24 beside them, which the kernels run at the tile of 16 or 32
with zero columns.

Tolerance 2e-5 absolute in f32 on outputs and dq, dk, dv (the JAX
package's own attention tolerance, tests/test_pallas_attention.py), 1e-4
on dbias, which sums the windows' dS in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models.swin2d import shifted_window_mask
from icl_tpu.ops.pallas.window_attention import window_attention_fused, window_attention_reference

from icl_tpu_torch.ops import window_attention as wa
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

H = 3
# N -> (grid side, window, shift) of a shifted Swin-UNet 2D block
GEOMETRY = {49: (14, 7, 3), 144: (24, 12, 6)}


def _mask(N, kind, rng):
    side, ws, shift = GEOMETRY[N]
    mask = shifted_window_mask(side, side, ws, shift)
    if kind == "random":
        mask = (3.0 * rng.standard_normal(mask.shape)).astype(np.float32)
    return mask


def _inputs(N, D, kind, seed, batch=2):
    rng = np.random.default_rng(seed)
    mask = _mask(N, kind, rng)
    B = batch * mask.shape[0]
    q, k, v, g = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    return q, k, v, bias, mask, g


CASES = [(N, D, kind) for N in sorted(GEOMETRY) for D in (16, 32) for kind in ("shift", "random")]
# the head dims below each tile, at the 224^2 / window-7 shape
OTHER_HEAD_DIMS = [(49, D, kind) for D in (4, 8, 12, 24) for kind in ("shift", "random")]


@pytest.mark.parametrize("N,D,kind", CASES + OTHER_HEAD_DIMS)
def test_plain_forward_matches_jax(N, D, kind):
    q, k, v, bias, mask, _ = _inputs(N, D, kind, seed=N + D)
    scale = D**-0.5
    jq, jk, jv, jb, jm = map(jnp.asarray, (q, k, v, bias, mask))
    fused = window_attention_fused(jq, jk, jv, jb, jm, scale=scale, interpret=True)
    ref = window_attention_reference(jq, jk, jv, jb, jm, scale=scale)
    got = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias)),
                                    mask=torch.from_numpy(mask), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def _jax_grads(fn, q, k, v, bias, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, bias)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("N,D,kind", CASES + OTHER_HEAD_DIMS)
def test_plain_backward_matches_jax_vjp(N, D, kind):
    q, k, v, bias, mask, g = _inputs(N, D, kind, seed=N + D + 1)
    scale = D**-0.5
    jm = jnp.asarray(mask)
    fused = _jax_grads(lambda *a: window_attention_fused(*a, jm, scale=scale, interpret=True),
                       q, k, v, bias, g)
    ref = _jax_grads(lambda *a: window_attention_reference(*a, jm, scale=scale), q, k, v, bias, g)
    got = wa.window_attention_plain_bwd(*map(torch.from_numpy, (q, k, v, bias)), None,
                                        torch.from_numpy(g), scale=scale,
                                        mask=torch.from_numpy(mask))
    for name, x, f, r in zip(("dq", "dk", "dv", "dbias"), got, fused, ref):
        atol = 1e-4 if name == "dbias" else 2e-5
        np.testing.assert_allclose(x.numpy(), f, atol=atol, err_msg=f"{name} vs fused")
        np.testing.assert_allclose(x.numpy(), r, atol=atol, err_msg=f"{name} vs reference")


def test_shift_mask_and_its_region_ids_give_the_same_attention():
    """The dense shift mask and the region ids it comes from are two
    encodings of one function, in both directions (chunk of one window in
    the backward, so the window index of every chunk is exercised)."""
    side, ws, shift = GEOMETRY[49]
    img = np.zeros((side, side), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    ids = img.reshape(side // ws, ws, side // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    q, k, v, bias, mask, g = _inputs(49, 16, "shift", seed=5)
    np.testing.assert_array_equal(wa.mask_from_region_ids(torch.from_numpy(ids)).numpy(), mask)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    by_ids = wa.window_attention_plain(*args, torch.from_numpy(ids), scale=0.25)
    by_mask = wa.window_attention_plain(*args, mask=torch.from_numpy(mask), scale=0.25)
    torch.testing.assert_close(by_mask, by_ids, rtol=0, atol=0)
    bwd_ids = wa.window_attention_plain_bwd(*args, torch.from_numpy(ids), torch.from_numpy(g),
                                            scale=0.25)
    bwd_mask = wa.window_attention_plain_bwd(*args, None, torch.from_numpy(g), scale=0.25,
                                             mask=torch.from_numpy(mask), chunk_bytes=1)
    for a, b in zip(bwd_mask, bwd_ids):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_function_gradcheck_f64_with_mask():
    """Finite differences of the forward against the plain backward, f64,
    tiny size (head dim 4, N 16, a random mask over 4 windows), along
    random directions (fast mode); the mask takes no gradient."""
    gen = torch.Generator().manual_seed(3)
    mask = torch.randn(4, 16, 16, generator=gen, dtype=torch.float64)
    q, k, v = (torch.randn(8, 1, 16, 4, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    bias = torch.randn(1, 16, 16, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: wa.window_attention(*a, mask=mask, scale=0.5), (q, k, v, bias), fast_mode=True)


def test_wrapper_with_mask_runs_plain_on_cpu_and_counts_no_launch():
    q, k, v, bias, mask, g = _inputs(49, 32, "shift", seed=6)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    m = torch.from_numpy(mask)
    wa.reset_launch_counts()
    out = wa.window_attention(*args, mask=m, scale=0.25)
    torch.testing.assert_close(out, wa.window_attention_plain(*args, mask=m, scale=0.25),
                               rtol=0, atol=0)
    got = torch.autograd.grad(out, args, torch.from_numpy(g))
    want = wa.window_attention_plain_bwd(*(a.detach() for a in args), None, torch.from_numpy(g),
                                         scale=0.25, mask=m)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert wa.window_attention.launches == wa.window_attention_bwd.launches == 0
    assert wa.window_attention.launches_by_mode == {"none": 0, "region": 0, "mask": 0}


def test_region_ids_and_mask_are_mutually_exclusive():
    q, k, v, bias, mask, _ = _inputs(49, 16, "shift", seed=7)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    ids = torch.zeros(mask.shape[:2])
    for fn in (wa.window_attention, wa.window_attention_plain):
        with pytest.raises(ValueError, match="mutually exclusive"):
            fn(*args, ids, torch.from_numpy(mask), scale=0.25)
