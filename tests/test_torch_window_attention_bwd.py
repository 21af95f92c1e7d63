"""The backward of icl_tpu_torch's fused window attention against the JAX
package's: `window_attention_plain_bwd` against `jax.vjp` of
`window_attention_fused` (Pallas forward in interpret mode, its custom_vjp
backward) and of `window_attention_reference`, with no mask, with
shift-region ids, and with the equivalent dense mask on the JAX side;
and `torch.autograd.gradcheck` of `WindowAttentionFn` in f64. The CUDA
backward kernel is held against the plain backward on the card, in
`test_torch_window_attention_card.py`.

Tolerance 2e-5 absolute in f32 (the JAX package's own attention
tolerance, tests/test_pallas_attention.py) on dq, dk, dv, and 1e-4 on
dbias, which sums the windows' dS in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models.swinunetr import compute_mask_3d
from icl_tpu.ops.pallas.window_attention import window_attention_fused, window_attention_reference

from icl_tpu_torch.models.swinunetr import window_region_ids_3d
from icl_tpu_torch.ops import window_attention as wa

D, H = 16, 3
SCALE = D**-0.5
# N -> (padded dims, window, shift) of a shifted stage with N tokens per window
GEOMETRY = {
    16: ((4, 4, 8), (2, 2, 4), (1, 1, 2)),
    49: ((14, 14, 1), (7, 7, 1), (3, 3, 0)),
}


def _inputs(N, seed, batch=2):
    dims, ws, ss = GEOMETRY[N]
    ids = window_region_ids_3d(dims, ws, ss)
    rng = np.random.default_rng(seed)
    B = batch * ids.shape[0]
    q, k, v, g = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    return q, k, v, bias, g, ids, compute_mask_3d(dims, ws, ss)


def _jax_grads(fn, q, k, v, bias, g):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, bias)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", ["none", "region", "dense"])
@pytest.mark.parametrize("N", sorted(GEOMETRY))
def test_plain_backward_matches_jax_vjp(N, case):
    """`dense` gives JAX the dense [nW, N, N] mask and the port the region
    ids it comes from: the same function, two encodings."""
    q, k, v, bias, g, ids, mask = _inputs(N, seed=N + len(case))
    kw = {"none": {}, "region": {"region_ids": jnp.asarray(ids)},
          "dense": {"mask": jnp.asarray(mask)}}[case]
    fused = _jax_grads(lambda *a: window_attention_fused(*a, scale=SCALE, interpret=True, **kw),
                       q, k, v, bias, g)
    ref = _jax_grads(lambda *a: window_attention_reference(
        *a, jnp.asarray(mask) if case != "none" else None, scale=SCALE), q, k, v, bias, g)
    got = wa.window_attention_plain_bwd(*map(torch.from_numpy, (q, k, v, bias)),
                                        torch.from_numpy(ids) if case != "none" else None,
                                        torch.from_numpy(g), scale=SCALE)
    for name, x, f, r in zip(("dq", "dk", "dv", "dbias"), got, fused, ref):
        atol = 1e-4 if name == "dbias" else 2e-5
        np.testing.assert_allclose(x.numpy(), f, atol=atol, err_msg=f"{name} vs fused")
        np.testing.assert_allclose(x.numpy(), r, atol=atol, err_msg=f"{name} vs reference")


def test_plain_backward_is_independent_of_its_chunking():
    """Chunks of one window give what one chunk of all windows gives (the
    chunk rule only bounds memory)."""
    q, k, v, bias, g, ids, _ = _inputs(16, seed=7, batch=3)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    whole = wa.window_attention_plain_bwd(*args, torch.from_numpy(ids), torch.from_numpy(g), scale=SCALE)
    tiny = wa.window_attention_plain_bwd(*args, torch.from_numpy(ids), torch.from_numpy(g), scale=SCALE,
                                         chunk_bytes=1)
    for a, b in zip(whole, tiny):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["none", "region"])
def test_function_gradcheck_f64(masked):
    """Finite differences of the forward against the plain backward, f64,
    tiny size (head dim 4, N 16), along random directions (fast mode)."""
    dims, ws, ss = GEOMETRY[16]
    ids = torch.from_numpy(window_region_ids_3d(dims, ws, ss)) if masked else None
    gen = torch.Generator().manual_seed(3)
    B = len(window_region_ids_3d(dims, ws, ss))
    q, k, v = (torch.randn(B, 1, 16, 4, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    bias = torch.randn(1, 16, 16, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: wa.window_attention(*a, ids, scale=0.5), (q, k, v, bias), fast_mode=True)


def test_backward_on_cpu_counts_no_launch():
    q, k, v, bias, g, ids, _ = _inputs(16, seed=8)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    wa.reset_launch_counts()
    got = wa.window_attention_bwd(*args, torch.from_numpy(ids), torch.from_numpy(g), scale=SCALE)
    want = wa.window_attention_plain_bwd(*args, torch.from_numpy(ids), torch.from_numpy(g), scale=SCALE)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert wa.window_attention_bwd.launches == 0
    assert wa.window_attention_bwd.launches_by_mode == {"none": 0, "region": 0, "mask": 0}
