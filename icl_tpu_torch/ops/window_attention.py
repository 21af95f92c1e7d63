"""Fused window attention: the CUDA kernels' wrappers, the autograd
Function around them, and their plain versions.

Counterpart of `icl_tpu/ops/pallas/window_attention.py`. Per (window,
head) the forward computes

    out = softmax(q.k^T * scale + bias[h] [+ M]) . v

where M is either built from shift-region ids (`region_ids` [nW, N]: -100
wherever the ids of key and query differ) or given as a dense additive
`mask` [nW, N, N]; the window index is b % nW, and the two are mutually
exclusive, as in `window_attention_fused`. Layout is that of
`window_attention_fused`: q, k, v [B*nW, H, N, D], bias [H, N, N].

`window_attention` is differentiable through `WindowAttentionFn`, which
saves its inputs (as `_fused_attention_fwd` does) and, at head dims above
32 and wherever the backward streams (`_saves_lse`), also its output and
the forward's row log-sum-exp: the backward then takes the softmax from
them (`window_attention_plain_bwd_lse` is its arithmetic) where at 32 and
below it recomputes the softmax's statistics.
On CUDA tensors the forward launches `csrc/window_attention.cu` and the
backward `csrc/window_attention_bwd.cu` (at head dims above 32 its tile-64
kernels, which need the saved output and log-sum-exp; above 64 their
chunked forms, `csrc/window_attention_wide.cu` and
`window_attention_bwd_wide.cu`, libraries of their own; where none of
those fits, the streamed kernels, `csrc/window_attention_stream.cu` and
`window_attention_bwd_stream.cu`: `_route`); on CPU tensors they
run `window_attention_plain` and `window_attention_plain_bwd` (or
`window_attention_plain_bwd_lse` where the output and log-sum-exp are
given). At head dims above 32 both directions run tile-64 kernels that
read bias (+ mask) from a term array [T, H, Np, Np] which their prologue
writes into scratch the wrapper allocates (`_terms`); the forward's is a
CTA of a producer warpgroup and one to three consumer warpgroups of 64 rows
(`_fwd64_groups`) on `wgmma`; above head dim 64 in f32 a pair of them on
the same 64 rows, each forming the partial scores of its own chunks, in
bf16 one to three, each holding its rows' accumulators of two output
chunks. Each kernel chooses its CTA's warps and
shared memory and reports them with its resident CTAs per SM
(`_fwd_geometry`, `_bwd_geometry`); `_grid_of` sizes both grids.
Each launch adds its FLOPs to any count in progress (`utils.flops`):
4*B*H*N^2*D forward, 10*B*H*N^2*D backward, what the plain versions'
matmuls count on the CPU.

Head dims: the kernels take every head dim D >= 1 (`_route` picks the
kernel). Where its shared memory fits a CTA, D runs the instance compiled
for its tile (`head_dim_tile`: 16 for D <= 16, 32 for D <= 32, 64 above),
whose operands are staged at the tile's width with zero columns past D;
above 64 the chunked tile-64 kernels walk D in `head_dim_chunks(D)` chunks
of 64 columns, a CTA per pair of output chunks ("tile" and "wide"). Where
those do not fit (f32 above 128; bf16 above 640 in the forward, at N =
343 above 128 in the backward; `_fwd_fits`, `_bwd64_smem_bytes`) the
streamed kernels take D ("stream"): a CTA per block of 64 rows (keys) and
pair of output chunks streams every chunk's tiles through a ring of two
buffers, its shared memory (`_STREAM_SMEM_BYTES`) and registers the same
at every D and N. SwinUNETR's head dim is feature_size / 3 (8 at fs24, 16
at fs48, 32 at fs96, 64 at fs192, 80 at fs240, 128 at fs384, 144 at
fs432); a 2D Swin's is EMBED_DIM / NUM_HEADS. At head dims up to 32 the
streamed kernels also take a window whose tiles do not fit a CTA
(`_bwd_tile_smem_bytes`), and a forward asked for its log-sum-exp, which
the tiles 16 and 32 do not store. Only D < 1 raises ValueError, on any
device (`_check`); the plain versions take any D. Launches are counted by
mode, by route (`launches_by_route`) and by both
(`launches_by_route_mode`).

Under tensor parallelism (counterpart of `_make_gspmd_fused` and
`_dispatch_forward`) each rank calls the same kernels on its own rows and
heads, q, k, v [B_local, H / M, N, D] with bias [H / M, N, N] (the
attention layers of `models/swin2d.py` and `models/swinunetr.py`), and
counts its own launches. A data rank's rows are whole images, so its
windows are whole (`_check` asserts nW | B); the JAX package's einsum
fallback for a misaligned shard has nothing to do here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from icl_tpu_torch.utils.flops import add_kernel_flops

HEAD_DIM_TILES = (16, 32, 64)  # the kernels' compiled tiles: the width D is staged at
SAVED_LSE_ABOVE = 32  # head dims above this: the backward takes the forward's output and lse
_BLOCK64 = 64  # rows of a tile-64 forward and dQ CTA (and keys of the dK/dV CTA)
_BWD64_QUADS = 2  # above head dim 64, the chunks of one tile-64 backward CTA (`kQuads`)
# above head dim 64, a forward CTA's output chunks (`kPair`), and in f32 its
# consumer warpgroups, on the same 64 rows, whose exchange of partial
# scores is two buffers of [64, 32] f32 each
_FWD_WIDE_PAIR = 2
_FWD_WIDE_MAX_SLOTS = 6  # its ring's slots at most (`kMaxSlots`)
_FWD_WIDE_MAX_SLOTS_SHARED = 4  # bf16's at one consumer warpgroup (`kMaxSlotsShared`)
_FWD_WIDE_MAX_CHUNKS_BF16 = 10  # the chunks a bf16 warpgroup holds Q of at most (`kMaxChunksBf16`)
_FWD_WIDE_PRODUCERS = 2  # f32's producer warpgroups (`Regs<false>::kProducers`)
_FWD_WIDE_EXCHANGE_BYTES = 2 * _FWD_WIDE_PAIR * 64 * 32 * 4
# above head dim 64, the exchange of partial scores (then dS; dK/dV: P and
# dS) between a backward CTA's two quads: 4 pairs of warps, 3 KB (dK/dV
# 4 KB) a pair (`kXchDq`, `kXchDkdv`)
_BWD64_EXCHANGE_BYTES = {"dq": 4 * 3072, "dkdv": 4 * 4096}
_MAX_SMEM_BYTES = 232_448  # per CTA on Hopper
ROUTES = ("tile", "wide", "stream")  # the kernels a call can take (`_route`)
# the streamed kernels: 64 rows (keys) a CTA, its pair of output chunks
# (`kStreamPair`), 32 keys a forward and dQ step, 16 rows a dK/dV step; a
# ring of two buffers, each a [64, 64] f32 tile beside a [32, 64] one (the
# dK/dV kernel's: [16, 64]), the same at every D and N
_STREAM_PAIR = 2
_STREAM_KEYS, _STREAM_ROWS = 32, 16
_STREAM_SMEM_BYTES = {"fwd": 2 * (64 + _STREAM_KEYS) * 64 * 4, "dq": 2 * (64 + _STREAM_KEYS) * 64 * 4,
                      "dkdv": 2 * (64 + _STREAM_ROWS) * 64 * 4}
_CHUNK_BYTES = 32 << 20  # the plain backward's score chunk (the JAX backward's rule)


def mask_from_region_ids(region_ids: torch.Tensor) -> torch.Tensor:
    """[nW, N] region ids -> additive mask [nW, N, N] (0 / -100)."""
    diff = region_ids[:, None, :] - region_ids[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=region_ids.device)
    return torch.where(diff != 0, zero - 100.0, zero)


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """f32 for f32 and bf16 inputs (the kernels' arithmetic); f64 stays
    f64, for gradcheck."""
    return torch.promote_types(q.dtype, torch.float32)


def _mode(region_ids, mask) -> str:
    if region_ids is not None and mask is not None:
        raise ValueError("window_attention: region_ids and mask are mutually exclusive")
    return "region" if region_ids is not None else "mask" if mask is not None else "none"


def window_attention_plain(q, k, v, bias, region_ids=None, mask=None, *, scale: float,
                           return_lse: bool = False):
    """Plain PyTorch version: einsum, + bias, + mask (from ids or dense),
    softmax, einsum. f32 arithmetic (f64 for f64 inputs), output in the
    dtype of q; with `return_lse` also the row log-sum-exp of the logits
    [B, H, N] in that arithmetic's dtype."""
    B, H, N, _ = q.shape
    ct = _compute_dtype(q)
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(ct), k.to(ct)) * scale
    s = s + bias.to(ct)[None]
    if _mode(region_ids, mask) != "none":
        if region_ids is not None:
            mask = mask_from_region_ids(region_ids.float())
        nW = mask.shape[0]
        s = (s.view(B // nW, nW, H, N, N) + mask.to(ct)[None, :, None]).view(B, H, N, N)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", p, v.to(ct)).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def _chunk_scores(qc, kc, bias, region_ids, mask, b0: int, scale: float) -> torch.Tensor:
    """f32 scores [b, H, N, N] of the windows b0 .. b0 + len(qc) - 1."""
    s = torch.einsum("bhnd,bhmd->bhnm", qc, kc) * scale + bias.to(qc.dtype)[None]
    if _mode(region_ids, mask) != "none":
        nW = (region_ids if region_ids is not None else mask).shape[0]
        widx = torch.arange(b0, b0 + qc.shape[0], device=qc.device) % nW
        if region_ids is not None:
            mask = mask_from_region_ids(region_ids.float()[widx])
        else:
            mask = mask[widx]
        s = s + mask.to(s.dtype)[:, None]
    return s


def window_attention_plain_bwd(q, k, v, bias, region_ids, dout, *, scale: float, mask=None,
                               chunk_bytes: int = _CHUNK_BYTES):
    """Plain PyTorch backward, a copy of `_fused_attention_bwd`: recompute
    the softmax over chunks of windows (chunk * H * N * N * 4 bytes <=
    `chunk_bytes`), ds = p * (dp - sum(dp * p)), dbias = sum of ds over
    windows. The mask (from `region_ids` or dense `mask`) takes no
    gradient. Returns (dq, dk, dv in the dtype of q, dbias in f32, or f64
    for f64 inputs)."""
    B, H, N, _ = q.shape
    ct = _compute_dtype(q)
    chunk = max(1, min(B, chunk_bytes // max(1, H * N * N * 4)))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.zeros((H, N, N), dtype=ct, device=q.device)
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        qc, kc, vc, gc = (t[sl].to(ct) for t in (q, k, v, dout))
        p = torch.softmax(_chunk_scores(qc, kc, bias, region_ids, mask, b0, scale), dim=-1)
        dv[sl] = torch.einsum("bhnm,bhnd->bhmd", p, gc).to(q.dtype)
        dp = torch.einsum("bhnd,bhmd->bhnm", gc, vc)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq[sl] = (torch.einsum("bhnm,bhmd->bhnd", ds, kc) * scale).to(q.dtype)
        dk[sl] = (torch.einsum("bhnm,bhnd->bhmd", ds, qc) * scale).to(q.dtype)
        dbias += ds.sum(0)
    return dq, dk, dv, dbias


def window_attention_plain_bwd_lse(q, k, v, bias, region_ids, out, lse, dout, *, scale: float,
                                   mask=None):
    """Plain PyTorch version of the tile-64 backward kernel's arithmetic:
    the softmax from the forward's row log-sum-exp, p = exp(s - lse), and
    u = rowsum(dout * out) from its output, in place of a softmax and
    rowsum(dp * p) recomputed from the scores; then ds = p * (dp - u) and
    the gradients as `window_attention_plain_bwd` forms them, over the same
    chunks of windows. An output rounded to bf16 would move u (and every
    ds, dbias by about 2e-3 of its size), so there, as in the kernel, u is
    rowsum(p * dp) in f32. Returns (dq, dk, dv in the dtype of q, dbias in
    f32, or f64 for f64 inputs)."""
    B, H, N, _ = q.shape
    ct = _compute_dtype(q)
    chunk = max(1, min(B, _CHUNK_BYTES // max(1, H * N * N * 4)))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.zeros((H, N, N), dtype=ct, device=q.device)
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        qc, kc, vc, gc, oc = (t[sl].to(ct) for t in (q, k, v, dout, out))
        p = torch.exp(_chunk_scores(qc, kc, bias, region_ids, mask, b0, scale) - lse[sl].to(ct)[..., None])
        dv[sl] = torch.einsum("bhnm,bhnd->bhmd", p, gc).to(q.dtype)
        dp = torch.einsum("bhnd,bhmd->bhnm", gc, vc)
        u = (gc * oc).sum(-1, keepdim=True) if out.dtype == ct else (p * dp).sum(-1, keepdim=True)
        ds = p * (dp - u)
        dq[sl] = (torch.einsum("bhnm,bhmd->bhnd", ds, kc) * scale).to(q.dtype)
        dk[sl] = (torch.einsum("bhnm,bhnd->bhmd", ds, qc) * scale).to(q.dtype)
        dbias += ds.sum(0)
    return dq, dk, dv, dbias


def head_dim_tile(D: int) -> int:
    """The tile of head dim D (`head_dim_tile` in `csrc/mma_tf32.cuh` up to
    64): the width the kernels stage D at, and so the instance that runs it
    (64 for every D above 32; above 64 in `head_dim_chunks(D)` chunks, the
    `_wide` libraries). Raises ValueError for D < 1."""
    if D < 1:
        raise ValueError(f"window_attention: head dim {D}, the kernels take head dims of 1 and above")
    return next((t for t in HEAD_DIM_TILES if D <= t), HEAD_DIM_TILES[-1])


def head_dim_chunks(D: int) -> int:
    """The 64-column chunks the tile-64 kernels walk head dim D in
    (`head_dim_chunks` in `csrc/mma_tf32.cuh`): 1 up to 64, ceil(D / 64)
    above, where each chunk of the output has CTAs (in the backward, quads
    of warps) of its own."""
    return 1 if D <= _BLOCK64 else -(-D // _BLOCK64)


def _fwd64_layout_bytes(groups: int, bf16: bool) -> int:
    """`Fwd64Layout(...).total` in `csrc/window_attention.cu` (head dims 33
    to 64): a kilobyte to align its tiles; each group's Q tile [64, 64]
    (f32 hi and lo, 32 KB; bf16 8 KB); a ring of S slots of 32 keys, each K
    (f32 hi and lo, 16 KB; bf16 4 KB) and V (f32 V^T hi and lo, 16 KB; bf16
    4 KB), S = 2 in f32 for one group, else 3; f32's plain V tiles [32, 64]
    (8 KB, one for one group, else two); each slot's 32 keys' region ids and
    two mbarriers."""
    slots = 2 if not bf16 and groups == 1 else 3
    if bf16:
        tiles = 8 * groups + 4 * slots * 2
    else:
        tiles = 32 * groups + 16 * slots * 2 + 8 * (1 if groups == 1 else 2)
    return 1024 + tiles * 1024 + slots * (32 * 4 + 16)


def _fwd_wide_layout_bytes(chunks: int, bf16: bool, groups: int = _FWD_WIDE_PAIR) -> int:
    """`fwd_wide_layout(...).total` in `csrc/window_attention_wide.cu`
    (head dims above 64, in `chunks` 64-column chunks): a kilobyte to align
    its tiles; each consumer warpgroup's Q tiles [64, 64] (f32: the pair's,
    ceil(C / 2) chunks each, hi and lo, 32 KB a chunk; bf16: `groups` of
    them, every chunk, 8 KB); a ring of S slots of 32 keys, each K of every
    chunk (f32 hi and lo, 16 KB; bf16 4 KB) and V of the CTA's two output
    chunks (f32 V^T hi and lo, 16 KB; bf16 4 KB); f32's exchange of partial
    scores between the pair (`_FWD_WIDE_EXCHANGE_BYTES`); each slot's 32
    keys' region ids and two mbarriers. S the most, up to
    `_FWD_WIDE_MAX_SLOTS` (bf16 at one warpgroup `_FWD_WIDE_MAX_SLOTS_SHARED`,
    so that two CTAs share an SM), that fit a CTA's shared memory, at least
    2."""
    most = _FWD_WIDE_MAX_SLOTS_SHARED if bf16 and groups == 1 else _FWD_WIDE_MAX_SLOTS
    slots = next((s for s in range(most, 2, -1) if _fwd_wide_bytes(chunks, bf16, groups, s) <= _MAX_SMEM_BYTES), 2)
    return _fwd_wide_bytes(chunks, bf16, groups, slots)


def _fwd_wide_bytes(chunks: int, bf16: bool, groups: int, slots: int) -> int:
    """`FwdWideLayout(...).total` at `slots` ring slots."""
    tile = 4 if bf16 else 16
    q = groups * chunks * 2 * tile if bf16 else _FWD_WIDE_PAIR * -(-chunks // _FWD_WIDE_PAIR) * 2 * tile
    tiles = q + slots * (chunks + _FWD_WIDE_PAIR) * tile
    return 1024 + tiles * 1024 + (0 if bf16 else _FWD_WIDE_EXCHANGE_BYTES) + slots * (32 * 4 + 16)


def _fwd64_groups(N: int, D: int = 64, bf16: bool = False) -> int:
    """Consumer warpgroups of a tile-64 forward CTA. Head dims up to 64
    (`groups64` in `csrc/window_attention.cu`): 3 or 2 where they divide the
    window's 64-row blocks and their layout fits a CTA's shared memory
    (always), else 1, each on 64 rows of its own. Above (`wide_groups` in
    `csrc/window_attention_wide.cu`): f32 the pair `_FWD_WIDE_PAIR`, both on
    the same 64 rows; bf16 3 or 2 where they divide the row blocks and their
    layout with two ring slots fits, else 1, each on rows of its own."""
    blocks, chunks = -(-N // _BLOCK64), head_dim_chunks(D)
    if chunks > 1 and not bf16:
        return _FWD_WIDE_PAIR

    def fits(g: int) -> bool:
        return (_fwd64_layout_bytes(g, bf16) if chunks == 1 else _fwd_wide_bytes(chunks, bf16, g, 2)) <= _MAX_SMEM_BYTES

    return next((g for g in (3, 2) if blocks % g == 0 and fits(g)), 1)


def _fwd_warps(N: int, D: int, bf16: bool = False) -> int:
    """Warps of a tile-64 forward CTA (`cta_warps` in the kernels): four a
    consumer warpgroup (`_fwd64_groups`) and a producer warpgroup, above
    head dim 64 in f32 two (`_FWD_WIDE_PRODUCERS`)."""
    producers = _FWD_WIDE_PRODUCERS if head_dim_chunks(D) > 1 and not bf16 else 1
    return 4 * (_fwd64_groups(N, D, bf16) + producers)


def _fwd_smem_bytes(N: int, D: int, bf16: bool = False) -> int:
    """The forward kernel's shared memory per CTA (`smem_bytes` in
    `csrc/window_attention.cu`). Tiles 16 and 32 (`head_dim_tile(D)`): two
    buffers of K and V [Np, tile] and the region ids [Np] in f32, Np = N
    padded to a multiple of 16. Tile 64: `_fwd64_layout_bytes` of
    `_fwd64_groups(N, D, bf16)` consumer warpgroups, independent of N but
    through them; above head dim 64 `_fwd_wide_layout_bytes` of its chunks
    and those warpgroups."""
    tile = head_dim_tile(D)
    if head_dim_chunks(D) > 1:
        return _fwd_wide_layout_bytes(head_dim_chunks(D), bf16, _fwd64_groups(N, D, bf16))
    if tile == 64:
        return _fwd64_layout_bytes(_fwd64_groups(N, D, bf16), bf16)
    Np = -(-N // 16) * 16
    return 2 * (2 * Np * tile + Np) * 4


def _fwd_fits(N: int, D: int, bf16: bool = False) -> bool:
    """Whether the forward kernel takes windows of N tokens at head dim D:
    its shared memory fits a CTA and, above head dim 64, a consumer
    warpgroup holds Q of its chunks (`takes` in
    `csrc/window_attention_wide.cu`: f32 one of two chunks, bf16 up to
    `_FWD_WIDE_MAX_CHUNKS_BF16`, all of them)."""
    chunks = head_dim_chunks(D)
    within = chunks <= (_FWD_WIDE_MAX_CHUNKS_BF16 if bf16 else _FWD_WIDE_PAIR)
    return within and _fwd_smem_bytes(N, D, bf16) <= _MAX_SMEM_BYTES


def _bwd64_smem_bytes(N: int, D: int, bf16: bool = False, region: bool = False) -> int:
    """The tile-64 backward's shared memory per CTA, the larger of its two
    kernels' (`DqLayout`, `DkdvLayout` in `csrc/window_attention_bwd.cu`,
    and above head dim 64 in `window_attention_bwd_wide.cu`) at C =
    `head_dim_chunks(D)`, Np = N padded to a multiple of 16, in floats:
    the dQ kernel's raw Q and dO [64, 64] of each chunk, then f32 two ring
    slots of K and V hi and lo [16, 64] of each chunk and a term tile
    [64, 16], bf16 the window's K and V [Np, 64] of each chunk (bf16 two to
    a float); the dK/dV kernel's K and V [64, 64] of each chunk (f32 hi and
    lo), then f32 two ring slots of Q and dO hi and lo [16, 64] of each
    chunk, a term tile and 32 floats of lse and u, bf16 the window's Q and
    dO of each chunk and its lse and u [Np]; at C > 1 f32 adds each
    kernel's exchange between its two quads (`_BWD64_EXCHANGE_BYTES`), which
    bf16 lays over the Q (dK/dV: K) tiles of chunks 0 and 1; both the ids
    [Np] in REGION."""
    C, Np = head_dim_chunks(D), -(-N // 16) * 16
    tile = 64 * 64 // (2 if bf16 else 1)  # floats of a [64, 64] tile
    if bf16:
        dq = 2 * C * tile + 2 * C * Np * 32
        dkdv = 2 * C * tile + 2 * C * Np * 32 + 2 * Np
    else:
        xdq, xdkdv = (_BWD64_EXCHANGE_BYTES[k] // 4 if C > 1 else 0 for k in ("dq", "dkdv"))
        dq = 2 * C * tile + 2 * (4 * C * 1024 + 1024) + xdq
        dkdv = 4 * C * tile + 2 * (4 * C * 1024 + 1024 + 32) + xdkdv
    return 4 * (max(dq, dkdv) + (Np if region else 0))


def _bwd_tile_smem_bytes(N: int, D: int) -> int:
    """The backward's shared memory per CTA at tiles 16 and 32 (`smem_bytes`
    in `csrc/window_attention_bwd.cu`): q, k, v and dO [Np, tile] and four
    rows [Np] (row max, 1 / row sum, rowsum(P o dP), the region ids), f32 in
    either type, Np = N padded to a multiple of 16."""
    Np = -(-N // 16) * 16
    return 4 * Np * (4 * head_dim_tile(D) + 4)


def _stream_smem_bytes(backward: bool = False) -> int:
    """The streamed kernels' shared memory per CTA (`kFwdSmemBytes`, and
    the larger of `kDqSmemBytes` and `kDkdvSmemBytes`): independent of the
    head dim, the window and the mode."""
    return max(_STREAM_SMEM_BYTES[k] for k in (("dq", "dkdv") if backward else ("fwd",)))


def _route(N: int, D: int, bf16: bool = False, backward: bool = False, region: bool = False,
           lse: bool = False) -> str:
    """The kernel a call at windows of N tokens and head dim D takes: the
    forward "tile" (head dims up to 64) or "wide" (above, in 64-column
    chunks) where `_fwd_fits` and, where its log-sum-exp is asked for
    (`lse`), the head dim is above 32, else "stream"; the backward the same
    where its shared memory fits (`_bwd_tile_smem_bytes` at head dims up to
    32, else `_bwd64_smem_bytes`, with the region ids where `region`), else
    "stream". Raises ValueError for D < 1."""
    head_dim_tile(D)
    if backward:
        smem = _bwd_tile_smem_bytes(N, D) if D <= SAVED_LSE_ABOVE else _bwd64_smem_bytes(N, D, bf16, region)
        fits = smem <= _MAX_SMEM_BYTES
    else:
        fits = _fwd_fits(N, D, bf16) and not (lse and D <= SAVED_LSE_ABOVE)
    return "stream" if not fits else "wide" if head_dim_chunks(D) > 1 else "tile"


def _saves_lse(N: int, D: int, bf16: bool, region: bool) -> bool:
    """Whether the backward at windows of N tokens and head dim D takes the
    forward's output and row log-sum-exp: above head dim 32 (the tile-64,
    chunked and streamed kernels) and wherever it streams."""
    return D > SAVED_LSE_ABOVE or (D >= 1 and _route(N, D, bf16, backward=True, region=region) == "stream")


def _check(q, k, v, bias, region_ids, mask, dout=None, lse: bool = False) -> str:
    """The inputs' shapes, types and devices as the kernels take them;
    returns the call's route (`_route`: forward, asking for the
    log-sum-exp where `lse`, or backward with `dout`)."""
    B, H, N, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: q dtype {q.dtype}, want float32 or bfloat16")
    named = [("k", k), ("v", v)] + ([("dout", dout)] if dout is not None else [])
    for name, t in named:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"window_attention: {name} {tuple(t.shape)} {t.dtype} "
                             f"!= q {tuple(q.shape)} {q.dtype}")
    if bias.shape != (H, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} {bias.dtype}, "
                         f"want ({H}, {N}, {N}) float32")
    route = _route(N, D, q.dtype == torch.bfloat16, dout is not None, region_ids is not None, lse)
    tensors = [q, k, v, bias] + ([dout] if dout is not None else [])
    if region_ids is not None:
        nW = region_ids.shape[0]
        if region_ids.shape != (nW, N) or region_ids.dtype != torch.float32 or B % nW:
            raise ValueError(f"window_attention: region_ids {tuple(region_ids.shape)} "
                             f"{region_ids.dtype}, want (nW, {N}) float32 with nW | {B}")
        tensors.append(region_ids)
    if mask is not None:
        nW = mask.shape[0]
        if mask.shape != (nW, N, N) or mask.dtype != torch.float32 or B % nW:
            raise ValueError(f"window_attention: mask {tuple(mask.shape)} {mask.dtype}, "
                             f"want (nW, {N}, {N}) float32 with nW | {B}")
        tensors.append(mask)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("window_attention: all inputs must be contiguous on one device")
    return route


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_attention: unsupported device {q.device}")
    return q.device.type


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: " + lib.icl_cuda_error_string(err).decode())


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _windows(B, region_ids, mask) -> int:
    """nW: the windows of the ids or the mask, else B."""
    t = region_ids if region_ids is not None else mask
    return B if t is None else t.shape[0]


def _window_groups(B: int, H: int, slots: int, whole_wave: bool = False) -> tuple[int, int]:
    """(windows per CTA, number of window groups) of either kernel: the
    (group, head) grid fills the card's `slots` resident CTAs (CTAs per
    SM, from the compiled kernel's registers and the window's shared
    memory, times the SMs) once, every group non-empty. `whole_wave`
    (the tile-64 forward and backward dQ kernels, whose `H` counts their
    CTAs of a group: heads times row blocks) keeps the grid within one
    wave."""
    groups = max(1, min(B, slots // H if whole_wave else -(-slots // H)))
    per_cta = -(-B // groups)
    return per_cta, -(-B // per_cta)


def _geometry(lib, what: str, N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
              device: int) -> tuple[int, int, int]:
    """(warps per CTA, shared memory per CTA in bytes, resident CTAs per
    SM) of kernel `what` for windows of N tokens at head dim D (the
    instance of its tile), as the kernel chooses them and the CUDA
    runtime's occupancy of the compiled kernel gives. Raises ValueError
    when the window does not fit an SM or D is not taken."""
    head_dim_tile(D)
    warps, smem, ctas = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = getattr(lib, f"icl_{what}_geometry")(N, D, int(has_ids), int(has_mask), int(bf16),
                                                   ctypes.byref(warps), ctypes.byref(smem),
                                                   ctypes.byref(ctas))
    _raise_on(err, lib, f"{what} geometry")
    if ctas.value < 1:
        raise ValueError(f"window_attention: window of {N} tokens at head dim {D} does not fit "
                         f"the {what} kernel's shared memory ({smem.value} bytes per CTA)")
    return warps.value, smem.value, ctas.value


@functools.cache
def _fwd_geometry(N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
                  device: int) -> tuple[int, int, int]:
    """`_geometry` of the forward kernel (above head dim 64 the chunked
    one's)."""
    from icl_tpu_torch.ops.build import load_window_attention

    wide = head_dim_chunks(D) > 1
    return _geometry(load_window_attention(wide), "window_attention_wide_fwd" if wide else "window_attention_fwd",
                     N, D, has_ids, has_mask, bf16, device)


@functools.cache
def _bwd_geometry(N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
                  device: int) -> tuple[int, int, int]:
    """`_geometry` of the backward kernel (above head dim 64 the chunked
    one's)."""
    from icl_tpu_torch.ops.build import load_window_attention_bwd

    wide = head_dim_chunks(D) > 1
    return _geometry(load_window_attention_bwd(wide), "window_attention_wide_bwd" if wide else "window_attention_bwd",
                     N, D, has_ids, has_mask, bf16, device)


@functools.cache
def _stream_fwd_geometry(N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
                         device: int) -> tuple[int, int, int]:
    """`_geometry` of the streamed forward kernel."""
    from icl_tpu_torch.ops.build import load_window_attention_stream

    return _geometry(load_window_attention_stream(), "window_attention_stream_fwd", N, D, has_ids, has_mask, bf16,
                     device)


@functools.cache
def _stream_bwd_geometry(N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
                         device: int) -> tuple[int, int, int]:
    """`_geometry` of the streamed backward kernels (the dQ kernel's CTAs
    an SM)."""
    from icl_tpu_torch.ops.build import load_window_attention_stream

    return _geometry(load_window_attention_stream(backward=True), "window_attention_stream_bwd", N, D, has_ids,
                     has_mask, bf16, device)


def _balanced_groups(B: int, ctas: int, slots: int) -> tuple[int, int]:
    """(windows per CTA, window groups) for `ctas` CTAs a group at `slots`
    resident CTAs, that make the fewest waves times windows a CTA, a CTA's
    prologue counted as one window more: at head dims above 64 a group
    has so many CTAs (row blocks x chunks x heads) that one wave of whole
    groups leaves SMs idle (fs240 stage 2: 72 CTAs of 132)."""
    def cost(groups: int) -> tuple[int, int]:
        per_cta = -(-B // groups)
        return -(-(-(-B // per_cta) * ctas) // slots) * (per_cta + 1), groups

    per_cta = -(-B // min(range(1, B + 1), key=cost))
    return per_cta, -(-B // per_cta)


def _grid_of(B: int, H: int, N: int, D: int, slots: int, rows: int = _BLOCK64,
             chunks_a_cta: int = 1) -> tuple[int, int]:
    """`_window_groups` of either kernel at `slots` resident CTAs: at tiles
    16 and 32 a CTA per (window group, head); at tile 64 a CTA per (block
    of `rows` rows, `chunks_a_cta` chunks of the head dim, head, window
    group): the forward's blocks are 64 rows a consumer warpgroup
    (`_fwd64_groups`) at head dims up to 64, above them 64 rows and
    `_FWD_WIDE_PAIR` chunks; the backward's dQ kernel's 64 and
    `_BWD64_QUADS`; within one wave at head dims up to 64,
    `_balanced_groups` above."""
    if head_dim_tile(D) == 64:
        ctas = H * -(-N // rows) * -(-head_dim_chunks(D) // chunks_a_cta)
        if head_dim_chunks(D) > 1:
            return _balanced_groups(B, ctas, slots)
        return _window_groups(B, ctas, slots, whole_wave=True)
    return _window_groups(B, H, slots)


def _stream_grid_of(B: int, H: int, N: int, D: int, slots: int) -> tuple[int, int]:
    """(windows per CTA, window groups) of the streamed kernels, both
    directions: a CTA per (block of 64 rows or keys, pair of output chunks,
    head) a group, `_balanced_groups` at `slots` resident CTAs."""
    ctas = H * -(-N // _BLOCK64) * -(-head_dim_chunks(D) // _STREAM_PAIR)
    return _balanced_groups(B, ctas, slots)


def _grid_blocks(fwd: bool, N: int, D: int, bf16: bool) -> tuple[int, int]:
    """(rows, chunks of the head dim) a CTA of the forward (`fwd`) or the
    backward's dQ kernel takes, as `_grid_of`'s `rows` and
    `chunks_a_cta`."""
    if not fwd:
        return _BLOCK64, _BWD64_QUADS
    if head_dim_chunks(D) > 1:  # f32's pair on one block; bf16's warpgroups a block each
        return _BLOCK64 * (_fwd64_groups(N, D, bf16) if bf16 else 1), _FWD_WIDE_PAIR
    return _BLOCK64 * _fwd64_groups(N, D, bf16), 1


@functools.cache
def _cached_grid(geometry, B: int, H: int, N: int, D: int, has_ids: bool, has_mask: bool,
                 bf16: bool, device: int) -> tuple[int, int]:
    _, _, ctas = geometry(N, D, has_ids, has_mask, bf16, device)
    slots = ctas * torch.cuda.get_device_properties(device).multi_processor_count
    if geometry in (_stream_fwd_geometry, _stream_bwd_geometry):
        return _stream_grid_of(B, H, N, D, slots)
    return _grid_of(B, H, N, D, slots, *_grid_blocks(geometry is _fwd_geometry, N, D, bf16))


def _grid(geometry, q, region_ids, mask) -> tuple[int, int]:
    """`_window_groups` of a call on q [B, H, N, D] to the kernel whose
    geometry query is `geometry` (`_fwd_geometry`, `_bwd_geometry` or
    their streamed forms),
    worked out once per call shape: the wrapper's host time sets the time
    per call at the smallest windows."""
    return _cached_grid(geometry, *q.shape, region_ids is not None, mask is not None,
                        q.dtype == torch.bfloat16, q.device.index)


def _terms(H: int, N: int, mask, device, pitch: int = 16) -> torch.Tensor:
    """Scratch for the tile-64 kernels' term array [T, H, Np, P] f32, bias
    (+ each window's mask, T = nW; else T = 1), Np = N padded to a multiple
    of 16, in rows P apart (N padded to a multiple of `pitch`: 16 for the
    backward, the forward's 32 keys a step for it), which their prologue
    writes."""
    Np = -(-N // 16) * 16
    planes = mask.shape[0] if mask is not None else 1
    return torch.empty((planes, H, Np, -(-N // pitch) * pitch), dtype=torch.float32, device=device)


def window_attention_fwd(q, k, v, bias, region_ids=None, mask=None, *, scale: float,
                         return_lse: bool = False):
    """The forward alone, without autograd: the kernel on CUDA tensors
    (built on first use; `_route`'s), `window_attention_plain` on CPU
    tensors. With `return_lse` also the row log-sum-exp [B, H, N] f32 (f64
    for f64 CPU inputs), which the kernel stores beside its output (at head
    dims up to `SAVED_LSE_ABOVE` the streamed kernel: the tiles 16 and 32
    store none)."""
    mode = _mode(region_ids, mask)
    if _device_of(q) == "cpu":
        if return_lse:
            return window_attention_plain(q, k, v, bias, region_ids, mask, scale=scale, return_lse=True)
        return window_attention_plain(q, k, v, bias, region_ids, mask, scale=scale)
    route = _check(q, k, v, bias, region_ids, mask, lse=return_lse)
    B, H, N, D = q.shape
    from icl_tpu_torch.ops.build import load_window_attention, load_window_attention_stream

    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "stream":
        lib = load_window_attention_stream()
        per_cta, _ = _grid(_stream_fwd_geometry, q, region_ids, mask)
        with torch.cuda.device(q.device):
            err = lib.icl_window_attention_stream_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _ptr(region_ids), _ptr(mask),
                out.data_ptr(), _ptr(lse), B, H, N, D, _windows(B, region_ids, mask), per_cta, float(scale),
                int(q.dtype == torch.bfloat16), stream)
    else:
        wide = route == "wide"  # the chunked tile-64 kernel's own library
        lib = load_window_attention(wide)
        per_cta, _ = _grid(_fwd_geometry, q, region_ids, mask)
        terms = _terms(H, N, mask, q.device, pitch=32) if head_dim_tile(D) == 64 else None
        with torch.cuda.device(q.device):
            err = (lib.icl_window_attention_wide_fwd if wide else lib.icl_window_attention_fwd)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _ptr(region_ids),
                _ptr(mask), out.data_ptr(), _ptr(lse), _ptr(terms), B, H, N, D,
                _windows(B, region_ids, mask), per_cta,
                float(scale), int(q.dtype == torch.bfloat16), stream,
            )
    _raise_on(err, lib, "window_attention")
    add_kernel_flops(4.0 * B * H * N * N * D)
    window_attention.launches += 1
    window_attention.launches_by_mode[mode] += 1
    window_attention.launches_by_route[route] += 1
    window_attention.launches_by_route_mode[route][mode] += 1
    return (out, lse) if return_lse else out


def _check_saved(q, out, lse) -> None:
    """The forward's output and row log-sum-exp, as the tile-64 and
    streamed backward kernels take them."""
    if out is None or lse is None:
        raise ValueError(f"window_attention_bwd: head dim {q.shape[-1]} runs the tile-64 or streamed backward, "
                         "which takes the forward's out and lse (window_attention_fwd(..., return_lse=True))")
    B, H, N, _ = q.shape
    if out.shape != q.shape or out.dtype != q.dtype or lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"window_attention_bwd: out {tuple(out.shape)} {out.dtype}, lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want {tuple(q.shape)} {q.dtype} and ({B}, {H}, {N}) float32")
    if out.device != q.device or lse.device != q.device or not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("window_attention_bwd: out and lse must be contiguous on q's device")


def window_attention_bwd(q, k, v, bias, region_ids, dout, *, scale: float, mask=None, out=None,
                         lse=None):
    """(dq, dk, dv, dbias) of the fused attention: the backward kernel on
    CUDA tensors (built on first use; `_route`'s); on CPU tensors
    `window_attention_plain_bwd_lse` where the forward's `out` and `lse`
    are given, else `window_attention_plain_bwd`. At head dims above 32,
    and wherever it streams (`_saves_lse`), the kernel is a tile-64 or
    streamed one, which needs `out` and `lse` (from
    `window_attention_fwd(..., return_lse=True)`) and raises without them;
    the tiles 16 and 32 recompute the softmax and leave them unread. dbias
    is f32; the rest keep the dtype of q."""
    mode = _mode(region_ids, mask)
    if _device_of(q) == "cpu":
        if lse is not None:
            return window_attention_plain_bwd_lse(q, k, v, bias, region_ids, out, lse, dout, scale=scale,
                                                  mask=mask)
        return window_attention_plain_bwd(q, k, v, bias, region_ids, dout, scale=scale, mask=mask)
    route = _check(q, k, v, bias, region_ids, mask, dout)
    B, H, N, D = q.shape
    tile64 = head_dim_tile(D) == 64
    if tile64 or route == "stream":
        _check_saved(q, out, lse)
    from icl_tpu_torch.ops.build import load_window_attention_bwd, load_window_attention_stream

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # rowsum(dO o O) (bf16: the dQ kernel's rowsum(P o dP))
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device) if tile64 or route == "stream" else None
    if route == "stream":
        lib = load_window_attention_stream(backward=True)
        per_cta, groups = _grid(_stream_bwd_geometry, q, region_ids, mask)
        part = torch.empty((groups, H, N, N), dtype=torch.float32, device=q.device)  # each window group's dbias
        with torch.cuda.device(q.device):
            err = lib.icl_window_attention_stream_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(), lse.data_ptr(),
                bias.data_ptr(), _ptr(region_ids), _ptr(mask), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                delta.data_ptr(), part.data_ptr(), dbias.data_ptr(), B, H, N, D, _windows(B, region_ids, mask),
                per_cta, float(scale), int(q.dtype == torch.bfloat16), stream)
    else:
        wide = route == "wide"  # the chunked tile-64 kernels' own library
        lib = load_window_attention_bwd(wide)
        per_cta, groups = _grid(_bwd_geometry, q, region_ids, mask)
        Np = -(-N // 16) * 16
        # the dbias partial of each window group; tile 64 keeps its rows Np apart
        part = torch.empty((groups, H, N, Np if tile64 else N), dtype=torch.float32, device=q.device)
        # bias (+ each window's mask) in rows Np apart
        terms = _terms(H, N, mask, q.device) if tile64 else None
        with torch.cuda.device(q.device):
            err = (lib.icl_window_attention_wide_bwd if wide else lib.icl_window_attention_bwd)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(out) if tile64 else None, _ptr(lse) if tile64 else None, bias.data_ptr(),
                _ptr(region_ids), _ptr(mask), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _ptr(delta), _ptr(terms), part.data_ptr(), dbias.data_ptr(), B, H, N, D,
                _windows(B, region_ids, mask), per_cta, float(scale), int(q.dtype == torch.bfloat16), stream,
            )
    _raise_on(err, lib, "window_attention_bwd")
    add_kernel_flops(10.0 * B * H * N * N * D)
    window_attention_bwd.launches += 1
    window_attention_bwd.launches_by_mode[mode] += 1
    window_attention_bwd.launches_by_route[route] += 1
    window_attention_bwd.launches_by_route_mode[route][mode] += 1
    return dq, dk, dv, dbias


class WindowAttentionFn(torch.autograd.Function):
    """The fused op under autograd (`_fused_attention`, a custom_vjp in the
    JAX package): saves q, k, v, bias and the region ids or the mask, and,
    where the backward takes them (`_saves_lse`) when a gradient will be
    asked for (`for_grad`: grad mode on and an input that requires one),
    its output and row log-sum-exp; its backward
    returns dq, dk, dv, dbias, and None for the ids and the mask, which is
    torch's spelling of the zero gradients the JAX backward returns for
    them (:346-347). Both directions run with autocast off, so the plain
    versions keep their f32 math."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region_ids, mask, scale, for_grad):
        ctx.scale = scale
        _, _, N, D = q.shape
        save_lse = for_grad and _saves_lse(N, D, q.dtype == torch.bfloat16, region_ids is not None)
        with torch.autocast(q.device.type, enabled=False):
            if save_lse:
                out, lse = window_attention_fwd(q, k, v, bias, region_ids, mask, scale=scale,
                                                return_lse=True)
            else:
                out, lse = window_attention_fwd(q, k, v, bias, region_ids, mask, scale=scale), None
        ctx.save_for_backward(q, k, v, bias, region_ids, mask, out if save_lse else None, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, region_ids, mask, out, lse = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dbias = window_attention_bwd(
                q, k, v, bias, region_ids, dout.contiguous().to(q.dtype), scale=ctx.scale,
                mask=mask, out=out, lse=lse)
        return dq, dk, dv, dbias, None, None, None, None


def window_attention(q, k, v, bias, region_ids=None, mask=None, *, scale: float):
    """Fused window attention, differentiable in q, k, v and bias. CUDA
    tensors go to the kernels; CPU tensors to the plain versions.
    `region_ids` and `mask` are mutually exclusive."""
    _device_of(q)
    _mode(region_ids, mask)
    # a gradient will be asked for (the forward runs under no_grad inside the Function)
    for_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias))
    return WindowAttentionFn.apply(q, k, v, bias, region_ids, mask, float(scale), for_grad)


def reset_launch_counts() -> None:
    """Kernel launches since the last reset, forward and backward, by
    mask mode, by route (`_route`) and by both, route first (the CPU path
    counts nothing)."""
    for fn in (window_attention, window_attention_bwd):
        fn.launches = 0
        fn.launches_by_mode = {"none": 0, "region": 0, "mask": 0}
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)
        fn.launches_by_route_mode = {r: {"none": 0, "region": 0, "mask": 0} for r in ROUTES}


reset_launch_counts()
