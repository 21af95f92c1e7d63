"""icl_tpu_torch window attention against the JAX package's: the plain
version against `window_attention_fused` (Pallas, interpret mode) and
`window_attention_reference`, with no mask and with shift-region ids.
The CUDA kernels run only on the card, against the plain versions, in
`test_torch_window_attention_card.py`. The backward has its own file,
`test_torch_window_attention_bwd.py`.

Tolerance atol 2e-5 in f32, the JAX package's own kernel tolerance
(tests/test_pallas_attention.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icl_tpu.models.swinunetr import compute_mask_3d
from icl_tpu.models.swinunetr import window_region_ids_3d as jax_region_ids
from icl_tpu.ops.pallas.window_attention import window_attention_fused, window_attention_reference

from icl_tpu_torch.models.swinunetr import window_region_ids_3d
from icl_tpu_torch.ops import window_attention as wa

D, H = 16, 3
# N -> (padded dims, window, shift) of a shifted stage with N tokens per window
GEOMETRY = {
    16: ((4, 4, 8), (2, 2, 4), (1, 1, 2)),
    49: ((14, 14, 1), (7, 7, 1), (3, 3, 0)),
    343: ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
}


def _inputs(N, seed):
    dims, ws, ss = GEOMETRY[N]
    ids = window_region_ids_3d(dims, ws, ss)
    np.testing.assert_array_equal(ids, jax_region_ids(dims, ws, ss))
    nW = ids.shape[0]
    assert ids.shape == (nW, N) and len(np.unique(ids)) > 1
    rng = np.random.default_rng(seed)
    B = 2 * nW
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    return q, k, v, bias, ids, compute_mask_3d(dims, ws, ss)


@pytest.mark.parametrize("masked", [False, True], ids=["none", "region"])
@pytest.mark.parametrize("N", sorted(GEOMETRY))
def test_plain_matches_jax(N, masked):
    q, k, v, bias, ids, mask = _inputs(N, seed=N)
    scale = D**-0.5
    jq, jk, jv, jb = map(jnp.asarray, (q, k, v, bias))
    if masked:
        fused = window_attention_fused(jq, jk, jv, jb, region_ids=jnp.asarray(ids), scale=scale,
                                       interpret=True)
        ref = window_attention_reference(jq, jk, jv, jb, jnp.asarray(mask), scale=scale)
    else:
        fused = window_attention_fused(jq, jk, jv, jb, scale=scale, interpret=True)
        ref = window_attention_reference(jq, jk, jv, jb, scale=scale)
    got = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias)),
                                    torch.from_numpy(ids) if masked else None, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_mask_from_region_ids_matches_jax():
    dims, ws, ss = GEOMETRY[343]
    got = wa.mask_from_region_ids(torch.from_numpy(window_region_ids_3d(dims, ws, ss)))
    np.testing.assert_array_equal(got.numpy(), compute_mask_3d(dims, ws, ss))


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    q, k, v, bias, ids, _ = _inputs(49, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    wa.reset_launch_counts()
    got = wa.window_attention(*args, torch.from_numpy(ids), scale=0.25)
    want = wa.window_attention_plain(*args, torch.from_numpy(ids), scale=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert wa.window_attention.launches == 0
    assert wa.window_attention.launches_by_mode == {"none": 0, "region": 0, "mask": 0}


@pytest.mark.parametrize("masked", [False, True], ids=["none", "region"])
def test_wrapper_gradients_flow_on_cpu_and_equal_plain_backward(masked):
    """Autograd through `window_attention` on CPU tensors gives exactly
    what `window_attention_plain_bwd` gives, and launches no kernel."""
    q, k, v, bias, ids, _ = _inputs(16, seed=2)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    rid = torch.from_numpy(ids) if masked else None
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32))
    wa.reset_launch_counts()
    out = wa.window_attention(*args, rid, scale=0.25)
    got = torch.autograd.grad(out, args, dout)
    want = wa.window_attention_plain_bwd(*(a.detach() for a in args), rid, dout, scale=0.25)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wa.window_attention.launches == wa.window_attention_bwd.launches == 0


def test_plain_keeps_bf16_output_dtype():
    q, k, v, bias, ids, _ = _inputs(16, seed=3)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [torch.from_numpy(bias)]
    out = wa.window_attention_plain(*args, torch.from_numpy(ids), scale=0.25)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
