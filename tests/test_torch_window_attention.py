"""icl_tpu_torch window attention against the JAX package's: the plain
version against `window_attention_fused` (Pallas, interpret mode) and
`window_attention_reference`, with no mask and with shift-region ids.
Head dim 16 (SwinUNETR fs48) and, beside it, 4, 8, 12, 24, 40 and 64
(fs12, fs24, fs36, fs72, fs120, fs192), which the kernels run at the tile
of 16, 32 or 64 with zero columns: the plain version is their oracle on
the card. The CUDA kernels
run only on the card, against the plain versions, in
`test_torch_window_attention_card.py`; the wrapper's rules for the head dim
(its tile, the shared memory at the tile, the refusals) are checked here. The backward has its own file,
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
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

D, H = 16, 3
# N -> (padded dims, window, shift) of a shifted stage with N tokens per window
GEOMETRY = {
    16: ((4, 4, 8), (2, 2, 4), (1, 1, 2)),
    49: ((14, 14, 1), (7, 7, 1), (3, 3, 0)),
    343: ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
}


def _inputs(N, seed, d=D):
    dims, ws, ss = GEOMETRY[N]
    ids = window_region_ids_3d(dims, ws, ss)
    np.testing.assert_array_equal(ids, jax_region_ids(dims, ws, ss))
    nW = ids.shape[0]
    assert ids.shape == (nW, N) and len(np.unique(ids)) > 1
    rng = np.random.default_rng(seed)
    B = 2 * nW
    q, k, v = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    return q, k, v, bias, ids, compute_mask_3d(dims, ws, ss)


def _plain_against_jax(N, d, masked, seed):
    q, k, v, bias, ids, mask = _inputs(N, seed=seed, d=d)
    scale = d**-0.5
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


@pytest.mark.parametrize("masked", [False, True], ids=["none", "region"])
@pytest.mark.parametrize("N", sorted(GEOMETRY))
def test_plain_matches_jax(N, masked):
    _plain_against_jax(N, D, masked, seed=N)


@pytest.mark.parametrize("masked", [False, True], ids=["none", "region"])
@pytest.mark.parametrize("d", [4, 8, 12, 24, 40, 64])
@pytest.mark.parametrize("N", [49, 343])
def test_plain_matches_jax_at_other_head_dims(N, d, masked):
    """SwinUNETR's head dims at feature sizes 12, 24, 36, 72, 120 and 192
    (fs / 3), at the 7^3 window (N 343) and a 7^2 one."""
    _plain_against_jax(N, d, masked, seed=N + d)


def test_head_dim_tile_and_the_forwards_shared_memory_at_it():
    """Head dims 1 .. 16 run the tile-16 instance, 17 .. 32 the tile-32
    one, every larger one the tile-64 kernel (above 64 in chunks, the
    rules of `test_torch_window_attention_wide.py`), 0 none; the forward's shared memory is that of
    the tile: at tiles 16 and 32 two buffers of K and V [Np, tile] and the
    ids [Np], f32 (N 343, Np 352, at fs24's head dim 8 takes what fs48's 16
    takes); at tile 64, for G consumer warpgroups (3 where N's 64-row
    blocks come in threes, N 144 and 343; 2 in twos, N 224; else 1), a
    kilobyte of alignment, G Q tiles (f32 32 KB, bf16 8 KB), a ring of
    32-key slots (f32 32 KB each, 3 of them, 2 for G = 1; bf16 8 KB, 3), in
    f32 plain V tiles (8 KB, 2; 1 for G = 1) and 144 bytes a slot of ids
    and mbarriers, the same for every head dim of the tile and, but for G,
    for every N (N 343: 214,448 bytes in f32, one CTA of 16 warps an SM)."""
    assert [wa.head_dim_tile(d) for d in (1, 4, 8, 10, 12, 16)] == [16] * 6
    assert [wa.head_dim_tile(d) for d in (17, 20, 24, 28, 32)] == [32] * 5
    assert [wa.head_dim_tile(d) for d in range(33, 65)] == [64] * 32
    assert wa._fwd_smem_bytes(343, 8) == wa._fwd_smem_bytes(343, 16) == 2 * (2 * 352 * 16 + 352) * 4
    assert wa._fwd_smem_bytes(144, 24) == wa._fwd_smem_bytes(144, 32) == 2 * (2 * 144 * 32 + 144) * 4
    assert wa._fwd_smem_bytes(144, 40) == wa._fwd_smem_bytes(144, 64) == 1024 + (96 + 96 + 16) * 1024 + 3 * 144
    assert wa._fwd_smem_bytes(224, 64) == 1024 + (64 + 96 + 16) * 1024 + 3 * 144 <= wa._MAX_SMEM_BYTES
    assert wa._fwd_smem_bytes(49, 64, bf16=True) == 1024 + (8 + 24) * 1024 + 3 * 144
    assert wa._fwd_smem_bytes(343, 48) == wa._fwd_smem_bytes(343, 64) == 1024 + 208 * 1024 + 3 * 144 == 214_448
    assert [wa.head_dim_tile(d) for d in (65, 96, 128, 640)] == [64] * 4
    with pytest.raises(ValueError, match="head dim 0, the kernels take head dims of 1 and above"):
        wa.head_dim_tile(0)


@pytest.mark.parametrize("d", [0, 129])
def test_check_refuses_a_head_dim_the_kernels_do_not_take(d):
    """The wrapper's check before a launch (on CPU tensors here: the rule
    does not need the card) refuses head dim 0, naming it; 129, the first
    in f32 whose three 64-column chunks fit neither chunked kernel's
    shared memory (the forward's pair of consumer warpgroups, the
    backward's dQ and dK/dV CTAs), it takes in both directions through the
    streamed kernels. The plain version takes both on the CPU."""
    q = torch.zeros(2, H, 49, d)
    bias = torch.zeros(H, 49, 49)
    if d == 0:
        with pytest.raises(ValueError, match=f"head dim {d}"):
            wa._check(q, q, q, bias, None, None)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            wa._check(q, q, q, bias, None, None, q)
    else:
        assert wa._check(q, q, q, bias, None, None) == wa._check(q, q, q, bias, None, None, q) == "stream"
    assert wa.window_attention(q, q, q, bias, scale=1.0).shape == q.shape


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
