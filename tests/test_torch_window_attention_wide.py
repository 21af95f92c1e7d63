"""Head dims above 64 in icl_tpu_torch's fused window attention, where the
tile-64 kernels walk the head dim in 64-column chunks (`head_dim_chunks`),
a CTA per pair of output chunks (in the forward a consumer warpgroup per
chunk, in the backward a quad of warps).

On the CPU: the rules the wrapper shares with the kernels (the tile, the
chunk count, the forward's consumer warpgroups and shared memory at every
chunk count it takes, the tile-64 backward's shared memory, the grids),
and the route each shape takes (the streamed kernels where the chunks do
not fit a CTA); and the plain versions that the kernels
are held against on the card (`test_torch_window_attention_card.py`)
against the JAX package at head dims 72, 80 (SwinUNETR fs240), 128
(fs384), 144 (fs432), 192 (a Swin-UNet at 192 a head) and 256: the
forward and its row log-sum-exp against the Pallas kernel in
interpret mode, the saved-LSE backward against `jax.vjp` of
`window_attention_fused`. No mask, region ids and a dense mask, N = 16
and 49; tolerances as `test_torch_window_attention_lse.py` states them
(2e-5 absolute, dbias 1e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.ops.pallas.window_attention import window_attention_fused

from icl_tpu_torch.ops import window_attention as wa
from test_torch_window_attention_lse import GEOMETRY, _inputs, _jax_scores
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

KB = 1024
# the forward's bytes a CTA above head dim 64: a kilobyte of alignment, the
# consumer warpgroups' Q tiles (f32: the pair's, ceil(C / 2) chunks each,
# 32 KB a chunk; bf16: G warpgroups' of every chunk, 8 KB), ring slots of K
# of every chunk and V of the CTA's two output chunks (f32 16 KB a chunk,
# bf16 4 KB), f32's exchange of partial scores between the pair (two
# buffers of [64, 32] f32 a warpgroup, 32 KB), 144 bytes a slot of ids and
# mbarriers; as many slots as fit, up to six (bf16 at one warpgroup four,
# so that two CTAs share an SM). f32 at 2 chunks: two slots, independent of
# N; bf16 at 2 chunks six at three warpgroups (N 343, 144), four at one (N
# 49); at 10 chunks (D 640) one warpgroup and three slots
FWD_F32_C2 = KB + (2 * 32 + 2 * 4 * 16 + 32) * KB + 2 * 144
FWD_BF16_C2_G3 = KB + (3 * 2 * 8 + 6 * 4 * 4) * KB + 6 * 144
FWD_BF16_C2_G1 = KB + (2 * 8 + 4 * 4 * 4) * KB + 4 * 144
FWD_BF16_C10 = KB + (10 * 8 + 3 * 12 * 4) * KB + 3 * 144
# the tile-64 backward's at 2 chunks, f32 (the dK/dV kernel's K and V hi
# and lo of 2 chunks, 128 KB, two ring slots of Q and dO hi and lo of 2
# chunks, a term tile, lse and u, and the 16 KB exchange between its two
# quads) and bf16 at N = 343 (the dK/dV kernel's resident Q and dO of 2
# chunks, [352, 64] bf16 each, K and V, lse and u; the exchange lies over
# K's tiles)
BWD_F32_C2 = 4 * (4 * 2 * 4096 + 2 * (4 * 2 * 1024 + 1024 + 32) + 4096)
BWD_BF16_C2_343 = 4 * (2 * 2 * 2048 + 2 * 2 * 352 * 32 + 2 * 352)


@pytest.mark.parametrize("D", [65, 72, 80, 127, 128, 192])
def test_head_dims_above_64_run_tile_64_in_chunks(D):
    """Every head dim above 64 runs the tile-64 kernels in ceil(D / 64)
    chunks; at 2 chunks the f32 forward's CTA is a pair of consumer
    warpgroups on one block of 64 rows, a chunk each, at every N, the bf16
    forward's one to three warpgroups on rows of their own where N's row
    blocks come in threes, twos or neither, and both directions fit, the
    chunked kernels ("wide") take them; at 3 chunks f32 fits neither
    direction, nor bf16's backward at N = 343, and the streamed kernels
    take those ("stream")."""
    chunks = -(-D // 64)
    assert wa.head_dim_tile(D) == 64 and wa.head_dim_chunks(D) == chunks
    assert wa.head_dim_chunks(64) == wa.head_dim_chunks(33) == 1
    if chunks == 2:
        for N in (343, 216, 144, 49, 4):
            assert wa._fwd64_groups(N, D) == wa._FWD_WIDE_PAIR == 2
            assert wa._fwd_warps(N, D) == 4 * (2 + wa._FWD_WIDE_PRODUCERS) == 16
            assert wa._fwd_warps(N, D, bf16=True) == 4 * (wa._fwd64_groups(N, D, bf16=True) + 1)
            assert wa._fwd_smem_bytes(N, D) == FWD_F32_C2 and wa._fwd_fits(N, D)
            assert wa._bwd64_smem_bytes(N, D) == BWD_F32_C2 == 221_440
            assert wa._route(N, D) == wa._route(N, D, backward=True, region=True) == "wide"
            assert wa._route(N, D, True) == wa._route(N, D, True, backward=True, region=True) == "wide"
        assert FWD_F32_C2 == 230_688 <= wa._MAX_SMEM_BYTES
        assert [wa._fwd64_groups(N, D, bf16=True) for N in (343, 216, 144, 49, 4)] == [3, 2, 3, 1, 1]
        assert wa._fwd_smem_bytes(343, D, bf16=True) == wa._fwd_smem_bytes(144, D, bf16=True) == FWD_BF16_C2_G3
        assert wa._fwd_smem_bytes(49, D, bf16=True) == FWD_BF16_C2_G1 and (FWD_BF16_C2_G3, FWD_BF16_C2_G1) == (
            149_344, 83_520)
        assert wa._bwd64_smem_bytes(343, D, bf16=True) == BWD_BF16_C2_343 == 215_808
        assert wa._bwd64_smem_bytes(343, D, bf16=True, region=True) == 215_808 + 4 * 352 <= wa._MAX_SMEM_BYTES
    else:
        assert wa._fwd_smem_bytes(49, D) > wa._MAX_SMEM_BYTES and not wa._fwd_fits(49, D)
        assert wa._bwd64_smem_bytes(49, D) > wa._MAX_SMEM_BYTES
        assert wa._bwd64_smem_bytes(343, D, bf16=True) > wa._MAX_SMEM_BYTES  # the resident window
        assert wa._bwd64_smem_bytes(49, D, bf16=True) <= wa._MAX_SMEM_BYTES
        assert wa._route(49, D) == wa._route(49, D, backward=True) == "stream"
        assert wa._route(343, D, True) == wa._route(49, D, True, backward=True) == "wide"
        assert wa._route(343, D, True, backward=True) == "stream"


def _bf16_forward_bytes(C: int, groups: int) -> int:
    """The bf16 chunked forward's bytes at C chunks and `groups` consumer
    warpgroups: Q of every chunk a warpgroup, as many ring slots of K of
    every chunk and V of two as fit, up to six (four at one warpgroup)."""
    def total(slots):
        return KB + (groups * C * 8 + slots * (C + 2) * 4) * KB + slots * 144

    most = 4 if groups == 1 else 6
    return total(max(s for s in range(2, most + 1) if s == 2 or total(s) <= wa._MAX_SMEM_BYTES))


@pytest.mark.parametrize("C", range(2, 11))
def test_forward_layout_fits_at_every_chunk_count_it_takes(C):
    """The chunked forward's shared memory at C chunks (head dims 64 C - 63
    to 64 C), independent of N but through its warpgroups: bf16 fits a CTA
    at N = 343 at every C up to 10, at the most warpgroups (3, 2, 1) that
    divide its six row blocks and fit with two ring slots, and as many
    slots as fit, up to six (four at one warpgroup); 11 chunks are
    refused. f32 fits at C = 2 at
    every N of GEOMETRY, the pair with two slots, and at no larger C. The
    route follows: the chunked kernel where it fits, else the streamed one
    (f32 above two chunks, bf16 at 11)."""
    groups = next(g for g in (3, 2, 1) if g == 1 or KB + (g * C * 8 + 2 * (C + 2) * 4) * KB + 2 * 144
                  <= wa._MAX_SMEM_BYTES)
    for D in (64 * C - 63, 64 * C):
        assert wa._fwd64_groups(343, D, bf16=True) == groups
        assert wa._fwd_smem_bytes(343, D, bf16=True) == _bf16_forward_bytes(C, groups) <= wa._MAX_SMEM_BYTES
        assert wa._fwd_fits(343, D, bf16=True)
        for N in sorted(GEOMETRY):
            assert wa._fwd_fits(N, D) == (C == 2) and wa._fwd_fits(N, D, bf16=True)
            assert wa._route(N, D) == ("wide" if C == 2 else "stream") and wa._route(N, D, True) == "wide"
    if C == 2:
        assert wa._fwd_smem_bytes(343, 128) == KB + (2 * 32 + 2 * 4 * 16 + 32) * KB + 2 * 144
    if C == 10:
        assert wa._fwd_smem_bytes(343, 640, bf16=True) == FWD_BF16_C10 == 230_832
        assert not wa._fwd_fits(343, 641, bf16=True)  # 11 chunks
        assert wa._route(343, 641, bf16=True) == "stream"


def test_largest_head_dims_each_kernel_takes():
    """The largest head dim each rule takes, at N = 343 and 49: the f32
    forward and backward 128 (two chunks); the bf16 forward 640 (ten chunks,
    the most a consumer warpgroup holds Q of: 80 KB, three ring slots of 48
    KB), the bf16 backward 128
    at N = 343 (its resident window of 3 chunks would need 323 KB) and
    448 at N = 49. Each largest runs its chunked kernel, and the next head
    dim the streamed one."""
    def largest(fits):
        return max(D for D in range(1, 1025) if fits(D))

    for N in (343, 49):
        assert largest(lambda D: wa._fwd_fits(N, D)) == 128
        assert largest(lambda D: wa._fwd_fits(N, D, bf16=True)) == 640
        assert largest(lambda D: wa._bwd64_smem_bytes(N, D, region=True) <= wa._MAX_SMEM_BYTES) == 128
    assert largest(lambda D: wa._bwd64_smem_bytes(343, D, True, True) <= wa._MAX_SMEM_BYTES) == 128
    assert largest(lambda D: wa._bwd64_smem_bytes(49, D, True, True) <= wa._MAX_SMEM_BYTES) == 448
    for N in (343, 49):
        assert (wa._route(N, 128), wa._route(N, 129)) == ("wide", "stream")
        assert (wa._route(N, 640, True), wa._route(N, 641, True)) == ("wide", "stream")
        assert [wa._route(N, D, backward=True, region=True) for D in (128, 129)] == ["wide", "stream"]
    assert [wa._route(343, D, True, True, True) for D in (128, 129)] == ["wide", "stream"]
    assert [wa._route(49, D, True, True, True) for D in (448, 449)] == ["wide", "stream"]


@pytest.mark.parametrize("region", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_backward_exchange_between_quads_fits_at_343(bf16, region):
    """The chunked backward's exchange between a CTA's two quads (partial
    scores, then dS; in the dK/dV kernel P and dS: 12 KB and 16 KB) at N =
    343, head dims 80 and 128: f32 adds it to the larger kernel's bytes
    (the dK/dV kernel's), bf16 lays it over the Q (dK/dV: K) tiles of chunks
    0 and 1 and keeps the bytes it had; with or without the region ids a
    CTA's shared memory holds it."""
    xch = wa._BWD64_EXCHANGE_BYTES
    assert (xch["dq"], xch["dkdv"]) == (12 * KB, 16 * KB)
    ids = 4 * 352 if region else 0
    for D in (80, 128):
        smem = wa._bwd64_smem_bytes(343, D, bf16, region)
        assert smem == (BWD_BF16_C2_343 if bf16 else BWD_F32_C2) + ids <= wa._MAX_SMEM_BYTES
    if bf16:
        assert max(xch.values()) <= 2 * 64 * 64 * 2  # two chunks of a [64, 64] bf16 tile
    else:
        assert BWD_F32_C2 - xch["dkdv"] == 205_056  # the dK/dV kernel's bytes without it


def _pair_partials(C: int) -> list[int]:
    """The chunk-products of S (and of dP) a quad of the chunked backward
    forms a step, quad j summing chunks j, j + 2, ... of the head dim."""
    return [len(range(j, C, wa._BWD64_QUADS)) for j in range(wa._BWD64_QUADS)]


@pytest.mark.parametrize("D,passes", [(80, 1), (128, 1), (192, 2), (448, 4)])
def test_backward_takes_a_pass_per_pair_of_output_chunks(D, passes):
    """The chunked backward walks its output chunks two at a time, a pass
    (a CTA of each row or key block) per pair, its quads splitting the
    partial scores of every chunk: at two chunks one pass forms the
    function's C chunk-products of S a step (the parent's quads formed 2 C);
    above two (bf16 at N = 49: 3 chunks at D 192, 7 at 448) every pass
    forms all C, and the grid has `passes` CTAs a block and head. bf16
    takes these windows, f32 does not above two chunks (the streamed
    kernels take those)."""
    C = wa.head_dim_chunks(D)
    assert -(-C // wa._BWD64_QUADS) == passes
    assert sum(_pair_partials(C)) == C and max(_pair_partials(C)) == -(-C // 2)
    assert wa._bwd64_smem_bytes(49, D, bf16=True, region=True) <= wa._MAX_SMEM_BYTES
    assert (wa._bwd64_smem_bytes(49, D, region=True) <= wa._MAX_SMEM_BYTES) == (C == 2)
    assert wa._route(49, D, True, backward=True, region=True) == "wide"
    assert wa._route(49, D, backward=True, region=True) == ("wide" if C == 2 else "stream")
    B, H, slots = 512, 3, 132
    per_cta, groups = wa._grid_of(B, H, 49, D, slots, 64, wa._BWD64_QUADS)
    ctas = H * 1 * passes  # one row block at N = 49
    assert groups * per_cta >= B > (groups - 1) * per_cta
    assert (per_cta, groups) == wa._balanced_groups(B, ctas, slots)


@pytest.mark.parametrize("D,dtype", [(129, torch.float32), (192, torch.bfloat16)])
def test_check_names_the_head_dim_and_window_it_refuses(D, dtype):
    """The shapes whose chunked kernels do not fit (which the wrapper
    refused, naming D and N, before the streamed kernels): the f32
    forward at 129, the bf16 backward at N = 343 and 192 (whose forward
    fits the chunked kernel). `_check` takes them and names the route."""
    q = torch.zeros(2, 1, 343, D, dtype=dtype)
    bias = torch.zeros(1, 343, 343)
    assert wa._check(q, q, q, bias, None, None) == ("stream" if dtype == torch.float32 else "wide")
    assert wa._check(q, q, q, bias, None, None, q) == "stream"


# (B, H, N, D, slots): fs240's and fs384's inference stage 1 and training
# stages, the 2D stage 1 at 3 heads of 128, a short window, and fewer
# slots than CTAs, at 132 SMs' resident CTAs
WIDE_GRIDS = [(1372, 3, 343, 80, 132), (686, 3, 343, 128, 132), (128, 6, 343, 80, 132), (4, 24, 216, 80, 132),
              (512, 3, 144, 128, 132), (512, 3, 49, 128, 132), (1024, 3, 4, 65, 264), (7, 3, 343, 128, 5)]


@pytest.mark.parametrize("B,H,N,D,slots", WIDE_GRIDS)
def test_wide_grids_have_a_cta_per_pair_of_chunks(B, H, N, D, slots):
    """Both tile-64 grids at head dims above 64: a CTA per (blocks of rows,
    pair of output chunks, head) and window group: f32's forward pair of
    consumer warpgroups and the backward dQ kernel's pair of quads a chunk
    each on one block of 64 rows, bf16's forward warpgroups a block each;
    every window once, no group empty, and no more waves times windows a
    CTA (one more for its prologue) than one wave of whole groups would
    take."""
    def waves_times_windows(per_cta, groups, ctas):
        return -(-groups * ctas // slots) * (per_cta + 1)

    assert wa._grid_blocks(True, N, D, False) == wa._grid_blocks(False, N, D, True) == (64, 2)
    assert wa._grid_blocks(True, N, D, True) == (64 * wa._fwd64_groups(N, D, True), 2)
    for fwd, bf16 in ((True, False), (True, True), (False, False)):
        rows, chunks_a_cta = wa._grid_blocks(fwd, N, D, bf16)
        per_cta, groups = wa._grid_of(B, H, N, D, slots, rows, chunks_a_cta)
        ctas = H * -(-N // rows) * -(-wa.head_dim_chunks(D) // chunks_a_cta)
        assert groups * per_cta >= B > (groups - 1) * per_cta
        assert waves_times_windows(per_cta, groups, ctas) <= waves_times_windows(
            *wa._window_groups(B, ctas, slots, whole_wave=True), ctas)
    if (B, H, N, D) == (1372, 3, 343, 80):  # fs240 stage 1: 6 blocks x 1 pair x 3 heads, 22 groups of 63 windows
        assert wa._grid_of(B, H, N, D, slots, 64, 2) == (63, 22)  # 3 waves of 132 CTAs


# 72, 80 and 128 the chunked kernels' two chunks; 144, 192 and 256 (three
# and four chunks) the streamed kernels' in f32
CASES = [(d, mode, N) for d in (72, 80, 128, 144, 192, 256) for mode in ("none", "region", "mask")
         for N in sorted(GEOMETRY)]


@pytest.mark.parametrize("d,mode,N", CASES)
def test_plain_forward_and_lse_match_pallas_above_64(d, mode, N):
    (q, k, v, _, bias), port, jx = _inputs(N, d, mode, seed=3 * N + d + len(mode))
    scale = d**-0.5
    out, lse = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias)), scale=scale, return_lse=True,
                                         **port)
    fused = np.asarray(window_attention_fused(*map(jnp.asarray, (q, k, v, bias)), scale=scale, interpret=True, **jx))
    np.testing.assert_allclose(out.numpy(), fused, atol=2e-5)
    want = np.asarray(jax.nn.logsumexp(_jax_scores(q, k, bias, jx, scale), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("d,mode,N", CASES)
def test_plain_lse_backward_matches_jax_vjp_above_64(d, mode, N):
    """dq, dk, dv, dbias of the tile-64 kernels' arithmetic (from the
    forward's out and lse) against JAX's custom_vjp."""
    (q, k, v, g, bias), port, jx = _inputs(N, d, mode, seed=5 * N + d + len(mode))
    scale = d**-0.5
    tq, tk, tv, tg, tbias = map(torch.from_numpy, (q, k, v, g, bias))
    out, lse = wa.window_attention_plain(tq, tk, tv, tbias, scale=scale, return_lse=True, **port)
    got = wa.window_attention_bwd(tq, tk, tv, tbias, port.get("region_ids"), tg, scale=scale,
                                  mask=port.get("mask"), out=out, lse=lse)
    _, vjp = jax.vjp(lambda *a: window_attention_fused(*a, scale=scale, interpret=True, **jx),
                     *map(jnp.asarray, (q, k, v, bias)))
    for name, x, f in zip(("dq", "dk", "dv", "dbias"), got, vjp(jnp.asarray(g))):
        assert x.shape == f.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(f), atol=1e-4 if name == "dbias" else 2e-5,
                                   err_msg=f"{name} vs JAX's vjp")
