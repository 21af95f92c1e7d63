"""The window-attention CUDA kernels against their plain PyTorch versions,
on the card only; every test here skips without one.

This file imports only torch, pytest and icl_tpu_torch: its oracles
are `window_attention_plain` and `window_attention_plain_bwd`, its region
ids and shift masks come from the port's own `window_region_ids_3d` and
`shifted_window_mask`. So it runs on a machine without JAX, with
tests/conftest.py (which imports JAX) left out:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_attention_card.py

Covered: forward and backward in NONE, REGION and MASK (the 2D shift mask
where N is a square, and a random dense mask), head dims 1, 4, 7, 8, 10,
12, 16, 20, 24, 28, 32, 33, 40, 48, 63 and 64 (SwinUNETR fs3, fs12, fs21,
fs24, fs30, fs36, fs48, fs60, fs72, fs84, fs96, fs99, fs120, fs144,
fs189, fs192; 1, 7, 10, 33 and 63, head dims that are not a multiple of 4,
take the kernels' value-by-value loads, 1, 7, 33 and 63 their
value-by-value stores); the tile-64 forward with and without its
log-sum-exp at head dims 33, 40, 48, 63 and 64 and N 343, 216, 144, 49 and
4 (3, 2 and 1 consumer warpgroups), and its geometry; above head dim 32 the backward is the tile-64
kernel, fed the forward kernel's output and row log-sum-exp, and is held
against both plain backwards (recomputing the softmax, and
`window_attention_plain_bwd_lse` from the same output and log-sum-exp); the
forward's log-sum-exp against the plain one, and the tile-64 backward's
refusal without them;
N in {4, 49, 144, 343}, f32 and bf16, each bitwise equal across two runs;
the same at the paths' shapes, where a CTA walks several windows (at
tile 64 both through the forward's one buffer, N = 343, and its two,
N = 144), and at rows that start off a 16-byte boundary; each kernel's
launch geometry (the forward's shared memory as `_check` reckons it at the
head dim's tile, and the refusal of a window that cannot fit); and the
refusal of head dims 0 and 129.

Head dims above 64 (the tile-64 kernels in 64-column chunks): 65, 72, 80
(SwinUNETR fs240), 96, 127 and 128 (fs384) at N 343, 216, 144, 49 and 4,
every mode, f32 and bf16, the forward with its log-sum-exp and the
backward fed them, as above; both kernels' geometry against the
wrapper's rules; the largest head dim each kernel's geometry takes at
N = 343 (f32 128 both; bf16 640 the forward, 128 the backward), run
there, and the next one refused with its D and N named; and the bf16
backward above two chunks (N = 49, D 192 and 448), every mode.

Every head dim (the streamed kernels, `window_attention_stream.cu` and
`window_attention_bwd_stream.cu`): head dims 129, 144 (SwinUNETR fs432),
192 (a Swin-UNet at 192 a head), 256 and 320 at N 343, 216, 144, 49 and 4,
no mask, region ids and a dense mask (the 2D shift mask where N is a
square, else a random one), f32 and bf16, on the streamed route (where
the rule would take the chunked kernel, as bf16's forward does up to 640,
with the rule patched to stream): the forward with its log-sum-exp and the
backward fed them, each bitwise repeatable, against the plain versions as
above; one chunk (head dims 1, 7, 16, 32 and 64) at windows of 450 to
1000 tokens whose tiles do not fit, through autograd; the route the rule
takes at D 128 / 129 (f32), 640 / 641 (the bf16 forward) and 128 / 129 at
N 343 (the bf16 backward), counted by `launches_by_route` and
`launches_by_route_mode`; their geometry; and head dim 129, and each
largest head dim + 1, run where they were refused before (head dim 0
still is).

Tolerances (those of chip_smoke.py): forward f32 1e-5 absolute (f32 sums
in another order, __expf), bf16 1e-3 + 1e-2 relative (one bf16 rounding
of the output); backward f32 1e-5 of each gradient's largest magnitude,
bf16 8e-3 on dq, dk, dv (one bf16 rounding) and 1e-5 on dbias (f32).
"""
import pytest
import torch

from icl_tpu_torch.models.swin2d import shifted_window_mask
from icl_tpu_torch.models.swinunetr import window_region_ids_3d
from icl_tpu_torch.ops import window_attention as wa

F32_ATOL = 1e-5
BF16_ATOL, BF16_RTOL = 1e-3, 1e-2
BWD_F32_RTOL, BWD_BF16_RTOL = 1e-5, 8e-3
H = 3
# N -> (padded dims, window, shift) of a shifted 3D stage with windows of N tokens
GEOMETRY_3D = {4: ((4, 4, 1), (2, 2, 1), (1, 1, 0)), 49: ((14, 14, 1), (7, 7, 1), (3, 3, 0)),
               144: ((12, 12, 8), (6, 6, 4), (3, 3, 2)), 343: ((14, 14, 14), (7, 7, 7), (3, 3, 3))}
# the head dims held: the tiles' own (16, 32, 64) and head dims below each
TILE_HEAD_DIMS = (1, 4, 7, 8, 10, 12, 16, 20, 24, 28, 32, 33, 40, 48, 63, 64)
# above 64: two chunks of the tile of 64 (65 and 127 not a multiple of 4)
WIDE_HEAD_DIMS = (65, 72, 80, 96, 127, 128)
HEAD_DIMS = TILE_HEAD_DIMS + WIDE_HEAD_DIMS  # chip_smoke.py's CARD_TEST_HEAD_DIMS
# the tile-64 forward's own sweep: N -> (padded dims, window, shift), its
# windows taking 3, 2 and 1 consumer warpgroups (343 and 144, 216, 49 and 4)
TILE64_GEOMETRY = {**GEOMETRY_3D, 216: ((12, 12, 12), (6, 6, 6), (3, 3, 3))}
TILE64_CASES = [(kind, N, D, dtype) for kind in ("none", "region", "random") for N in sorted(TILE64_GEOMETRY)
                for D in (33, 40, 48, 63, 64) for dtype in ("float32", "bfloat16")]
CASES = [(kind, N, D, dtype) for kind in ("none", "region", "shift", "random") for N in sorted(GEOMETRY_3D)
         for D in TILE_HEAD_DIMS for dtype in ("float32", "bfloat16") if kind != "shift" or N != 343]
WIDE_CASES = [(kind, N, D, dtype) for kind in ("none", "region", "random") for N in sorted(TILE64_GEOMETRY)
              for D in WIDE_HEAD_DIMS for dtype in ("float32", "bfloat16")]
# (kind, N, D, batch): shapes of the paths, with enough windows that a CTA
# walks several (2D stage 1, the 224^2 / window-7 stage 1, 3D stage 1 at
# fs48 and fs24, a 2 x 2 window), and a head dim off the multiples of 4
SEVERAL_WINDOWS = {"shift144": ("shift", 144, 32, 128), "random49": ("random", 49, 32, 128),
                   "region343": ("region", 343, 16, 128), "none4": ("none", 4, 32, 1024),
                   "region343_d8": ("region", 343, 8, 128), "none343_d10": ("none", 343, 10, 128),
                   "region343_d64": ("region", 343, 64, 128), "shift144_d48": ("shift", 144, 48, 128)}
# every (N, D) the port's paths call, and the other head dims at each N
SHAPES = [(n, d) for n in (4, 49, 144, 216, 343) for d in HEAD_DIMS]
# the streamed kernels: ragged and whole last chunks (129, 144, 192, 256,
# 320) at every window, no mask, region ids and a dense mask (the shift
# mask where N is a square)
STREAM_HEAD_DIMS = (129, 144, 192, 256, 320)
STREAM_CASES = [(kind if kind != "mask" else "shift" if N in (4, 49, 144) else "random", N, D, dtype)
                for kind in ("none", "region", "mask") for N in sorted(TILE64_GEOMETRY)
                for D in STREAM_HEAD_DIMS for dtype in ("float32", "bfloat16")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(kind, N, D, dtype, batch, seed, device):
    """q, k, v, bias, ids, mask of `batch` images' windows: `kind` none,
    region (ids of a shifted 3D stage), shift (the 2D shift mask) or
    random (a dense mask N(0, 3^2))."""
    ids = mask = None
    nW = 4
    if kind == "region":
        ids = torch.from_numpy(window_region_ids_3d(*TILE64_GEOMETRY[N])).to(device)
        nW = ids.shape[0]
    elif kind == "shift":  # a 2 x 2 grid of windows, shifted by half a window
        ws = int(round(N ** 0.5))
        mask = torch.from_numpy(shifted_window_mask(2 * ws, 2 * ws, ws, ws // 2)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "random":
        mask = 3.0 * torch.randn(nW, N, N, device=device, generator=gen)
    q, k, v = (torch.randn(batch * nW, H, N, D, device=device, generator=gen).to(getattr(torch, dtype))
               for _ in range(3))
    bias = torch.randn(H, N, N, device=device, generator=gen)
    return q, k, v, bias, ids, mask


def _mode(ids, mask):
    return "region" if ids is not None else "mask" if mask is not None else "none"


def _check_forward(q, k, v, bias, ids, mask):
    scale = q.shape[-1] ** -0.5
    wa.reset_launch_counts()
    got = wa.window_attention(q, k, v, bias, ids, mask, scale=scale)
    again = wa.window_attention(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    want = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale)
    assert torch.equal(got, again), "the forward is not bitwise repeatable"
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        assert float(err.max()) <= F32_ATOL, float(err.max())
    else:
        assert bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(err.max())
    assert wa.window_attention.launches_by_mode[_mode(ids, mask)] == wa.window_attention.launches == 2


def _upstream(q):
    """dO for the backward checks: N(0, 1) of q's shape and type."""
    g = torch.randn(q.shape, device=q.device, generator=torch.Generator(device=q.device).manual_seed(9))
    return g.to(q.dtype)


def _saved(q, k, v, bias, ids, mask, scale):
    """The forward kernel's output and row log-sum-exp where the backward
    takes them (the tile-64 kernel, head dims above 32), as
    `WindowAttentionFn` saves them; {} below."""
    if q.shape[-1] <= wa.SAVED_LSE_ABOVE:
        return {}
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    return {"out": out, "lse": lse}


def _check_backward(q, k, v, bias, ids, mask, g=None):
    scale = q.shape[-1] ** -0.5
    g = _upstream(q) if g is None else g
    saved = _saved(q, k, v, bias, ids, mask, scale)
    wa.reset_launch_counts()
    got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, **saved)
    again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, **saved)
    torch.cuda.synchronize()
    wants = [wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)]
    if saved:
        wants.append(wa.window_attention_plain_bwd_lse(q, k, v, bias, ids, saved["out"], saved["lse"], g,
                                                       scale=scale, mask=mask))
    for want in wants:
        for name, a, b, w in zip(("dq", "dk", "dv", "dbias"), got, again, want):
            assert torch.equal(a, b), f"{name} is not bitwise repeatable"
            assert bool(torch.isfinite(a).all()), name
            tol = BWD_F32_RTOL if q.dtype == torch.float32 or name == "dbias" else BWD_BF16_RTOL
            err = float((a.float() - w.float()).abs().max() / w.float().abs().max())
            assert err <= tol, (name, err)
    assert wa.window_attention_bwd.launches_by_mode[_mode(ids, mask)] == wa.window_attention_bwd.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,dtype", CASES)
def test_forward_kernel_matches_plain_on_card(card, kind, N, D, dtype):
    _check_forward(*_inputs(kind, N, D, dtype, batch=2, seed=N + D, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,dtype", CASES)
def test_backward_kernel_matches_plain_on_card(card, kind, N, D, dtype):
    _check_backward(*_inputs(kind, N, D, dtype, batch=2, seed=N + D + 1, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [33, 40, 64])
@pytest.mark.parametrize("N", [49, 144, 343])
@pytest.mark.parametrize("kind", ["none", "region", "random"])
def test_forward_log_sum_exp_matches_plain_on_card(card, kind, N, D, dtype):
    """The row log-sum-exp the forward kernel stores for the tile-64
    backward, against the plain version's (f32 1e-5 of its magnitude, as
    the output: f32 sums in another order, __expf); storing it leaves the
    output's bits as they are."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, dtype, batch=2, seed=N + D + 2, device=card)
    scale = D ** -0.5
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    _, want = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    assert torch.equal(out, alone)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    err = float((lse - want).abs().max())
    assert err <= F32_ATOL * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,dtype", TILE64_CASES)
def test_tile64_forward_and_its_log_sum_exp_match_plain_on_card(card, kind, N, D, dtype):
    """The tile-64 forward (wgmma, a producer and 1-3 consumer warpgroups)
    at head dims 33, 40, 48, 63 and 64 and windows of 343, 216, 144, 49 and
    4 tokens, every mode: the output without and with the log-sum-exp store
    (equal bits, both bitwise repeatable) against the plain version, the
    log-sum-exp against the plain one (f32 1e-5 of its magnitude)."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, dtype, batch=2, seed=N + D + 5, device=card)
    scale = D ** -0.5
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    out2, lse2 = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, alone)
    assert out.dtype == q.dtype and bool(torch.isfinite(out).all())
    err = (out.float() - want.float()).abs()
    if q.dtype == torch.float32:
        assert float(err.max()) <= F32_ATOL, float(err.max())
    else:
        assert bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(err.max())
    lse_err = float((lse - want_lse).abs().max())
    assert lse_err <= F32_ATOL * max(1.0, float(want_lse.abs().max())), lse_err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [343, 216, 144, 49, 4])
def test_tile64_forward_geometry_on_card(card, N, dtype):
    """The tile-64 forward's CTA: a producer warpgroup and G consumer
    warpgroups of 64 rows (3 at N 343 and 144, 2 at 216, 1 at 49 and 4),
    the shared memory `_check` reckons in every mode; at three consumer
    warpgroups one CTA of 16 warps an SM in f32 (214,448 bytes of shared
    memory: two would need 428 KB), at one, two CTAs of 8 warps."""
    bf16 = dtype == "bfloat16"
    groups = wa._fwd64_groups(N)
    for has_ids, has_mask in ((False, False), (True, False), (False, True)):
        warps, smem, ctas = wa._fwd_geometry(N, 64, has_ids, has_mask, bf16, card.index)
        assert (warps, smem) == (4 * (groups + 1), wa._fwd_smem_bytes(N, 64, bf16)), (warps, smem)
        assert ctas >= (1 if groups > 1 or bf16 else 2), ctas
    assert groups == {343: 3, 216: 2, 144: 3, 49: 1, 4: 1}[N]


@pytest.mark.cuda
def test_tile64_backward_refuses_without_the_saved_forward_on_card(card):
    """No fallback: at head dims above 32 the backward kernel needs the
    forward's output and log-sum-exp, and a call without them raises."""
    q, k, v, bias, ids, _ = _inputs("region", 49, 40, "float32", batch=2, seed=3, device=card)
    with pytest.raises(ValueError, match="return_lse=True"):
        wa.window_attention_bwd(q, k, v, bias, ids, q, scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEVERAL_WINDOWS))
def test_kernels_walking_several_windows_per_cta_match_plain_on_card(card, case):
    kind, N, D, batch = SEVERAL_WINDOWS[case]
    q, k, v, bias, ids, mask = _inputs(kind, N, D, "float32", batch=batch, seed=N, device=card)
    for geometry in (wa._fwd_geometry, wa._bwd_geometry):
        per_cta, _ = wa._grid(geometry, q, ids, mask)
        assert per_cta >= 2, (geometry.__name__, per_cta)
    _check_forward(q, k, v, bias, ids, mask)
    _check_backward(q, k, v, bias, ids, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [4, 8, 16, 40])
def test_kernels_take_rows_off_a_16_byte_boundary_on_card(card, D, dtype):
    """q, k, v and dO one value past a 16-byte boundary (contiguous views
    into a larger buffer; in bf16 also off the 8-byte boundary that its
    8-byte loads need): the kernels stage them value by value and agree
    with the plain versions as at aligned rows."""
    q, k, v, bias, ids, mask = _inputs("region", 343, D, dtype, batch=2, seed=D, device=card)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.data_ptr() % 8 != 0
        return view

    q, k, v = map(shifted, (q, k, v))
    _check_forward(q, k, v, bias, ids, mask)
    _check_backward(q, k, v, bias, ids, mask, shifted(_upstream(q)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,dtype", WIDE_CASES)
def test_wide_kernels_and_the_log_sum_exp_match_plain_on_card(card, kind, N, D, dtype):
    """Head dims above 64, a CTA per pair of 64-column chunks of the output:
    the forward with and without its log-sum-exp store (equal bits, bitwise
    repeatable) against the plain version, the log-sum-exp against the
    plain one (only pair 0's CTAs store it), then the backward fed that
    output and log-sum-exp against both plain backwards (dbias written by
    chunk 0's dQ CTAs alone), as at head dims up to 64."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, dtype, batch=2, seed=N + D + 7, device=card)
    scale = D ** -0.5
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    _, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    assert torch.equal(out, alone)
    lse_err = float((lse - want_lse).abs().max())
    assert lse_err <= F32_ATOL * max(1.0, float(want_lse.abs().max())), lse_err
    _check_forward(q, k, v, bias, ids, mask)
    _check_backward(q, k, v, bias, ids, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [192, 448])
@pytest.mark.parametrize("kind", ["none", "region", "random"])
def test_wide_backward_above_two_chunks_matches_plain_on_card(card, kind, D):
    """bf16 above two chunks (N = 49: 3 chunks at D 192, 7 at D 448, the
    largest the backward takes there), where each pair of output chunks is
    a CTA of its own whose quads sum the partial scores of chunks j, j + 2,
    ... (and read them past chunk 1 from the staged tiles): the backward fed
    the forward's output and log-sum-exp against both plain backwards,
    bitwise repeatable, as at two chunks."""
    _check_backward(*_inputs(kind, 49, D, "bfloat16", batch=2, seed=D + len(kind), device=card))


# the bf16 forward above two chunks: 3, 5 and 10 chunks (the largest it
# takes), a CTA per pair of output chunks
WIDE_FWD_ABOVE_TWO = [(kind, N, D) for kind in ("none", "region", "random") for N in (49, 343)
                      for D in (192, 320, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D", WIDE_FWD_ABOVE_TWO)
def test_wide_forward_above_two_chunks_matches_plain_on_card(card, kind, N, D):
    """bf16 above two chunks, each pair of output chunks a CTA of its own
    whose warpgroups sum the scores over every chunk (the last pair at an
    odd count storing one chunk): the output
    with and without the log-sum-exp store (equal bits), both bitwise
    repeatable, against the plain version, the log-sum-exp against the
    plain one, and the launch counted once a call."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, "bfloat16", batch=2, seed=N + D + 13, device=card)
    scale = D ** -0.5
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    out2, lse2 = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, alone)
    err = (out.float() - want.float()).abs()
    assert bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(err.max())
    lse_err = float((lse - want_lse).abs().max())
    assert lse_err <= F32_ATOL * max(1.0, float(want_lse.abs().max())), lse_err
    _check_forward(q, k, v, bias, ids, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_wide_geometry_agrees_with_the_rules_on_card(card, D, dtype):
    """Both kernels' geometry above head dim 64 is what the wrapper
    reckons: the forward's producer and consumer warpgroups (f32 two
    producers and the pair `_FWD_WIDE_PAIR` at every N, one CTA an SM;
    bf16 one producer and `_fwd64_groups`: 3 at N 343 and 144, 2 at 216, 1
    at 49 and 4, two CTAs an SM) and `_fwd_wide_layout_bytes`,
    the backward's two quads of four warps (a chunk each) and
    `_bwd64_smem_bytes`, at least one CTA an SM."""
    bf16 = dtype == "bfloat16"
    for N in sorted(TILE64_GEOMETRY):
        groups = wa._fwd64_groups(N, D, bf16)
        assert groups == ({343: 3, 216: 2, 144: 3, 49: 1, 4: 1}[N] if bf16 else wa._FWD_WIDE_PAIR)
        for has_ids, has_mask in ((False, False), (True, False), (False, True)):
            warps, smem, ctas = wa._fwd_geometry(N, D, has_ids, has_mask, bf16, card.index)
            assert (warps, smem) == (wa._fwd_warps(N, D, bf16), wa._fwd_wide_layout_bytes(2, bf16, groups))
            assert warps == 4 * (groups + (1 if bf16 else wa._FWD_WIDE_PRODUCERS))
            assert smem == wa._fwd_smem_bytes(N, D, bf16) and ctas >= 1 and (bf16 or ctas == 1), ctas
            assert groups > 1 or not bf16 or ctas == 2, ctas  # one warpgroup: two CTAs share an SM
            warps, smem, ctas = wa._bwd_geometry(N, D, has_ids, has_mask, bf16, card.index)
            assert (warps, smem) == (4 * wa._BWD64_QUADS, wa._bwd64_smem_bytes(N, D, bf16, has_ids)) and ctas >= 1, \
                (N, warps, smem, ctas)


# the largest head dim each chunked kernel takes at N = 343 (f32, bf16), as
# the wrapper's rules give it (test_torch_window_attention_wide.py)
LARGEST_AT_343 = {"forward": (128, 640), "backward": (128, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_largest_head_dims_at_343_run_and_the_next_is_refused_on_card(card, dtype):
    """At N = 343 (REGION) each chunked kernel's geometry takes its largest
    head dim and refuses the next, naming D and N; the forward at its
    largest and the backward at its largest match the plain versions; the
    next head dim runs through the streamed kernels and matches them too."""
    bf16 = dtype == "bfloat16"
    for what, geometry in (("forward", wa._fwd_geometry), ("backward", wa._bwd_geometry)):
        D = LARGEST_AT_343[what][bf16]
        assert geometry(343, D, True, False, bf16, card.index)[2] >= 1
        with pytest.raises(ValueError, match=f"window of 343 tokens at head dim {D + 1} does not fit"):
            geometry(343, D + 1, True, False, bf16, card.index)
    q, k, v, bias, ids, mask = _inputs("region", 343, LARGEST_AT_343["forward"][bf16], dtype, batch=1, seed=11,
                                       device=card)
    _check_forward(q, k, v, bias, ids, mask)
    q, k, v, bias, ids, mask = _inputs("region", 343, LARGEST_AT_343["backward"][bf16], dtype, batch=1, seed=12,
                                       device=card)
    _check_backward(q, k, v, bias, ids, mask)
    for what, check in (("forward", _check_forward), ("backward", _check_backward)):
        D = LARGEST_AT_343[what][bf16] + 1
        check(*_inputs("region", 343, D, dtype, batch=1, seed=D, device=card))
        counts = (wa.window_attention if what == "forward" else wa.window_attention_bwd).launches_by_route
        assert counts == {"tile": 0, "wide": 0, "stream": 2}, (what, D, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [0, 129])
def test_kernels_refuse_a_head_dim_they_do_not_take_on_card(card, D):
    """Head dim 0 is refused, naming it; 129, which the chunked kernels do
    not fit in f32, runs through the streamed kernels in both directions
    and matches the plain versions."""
    q = torch.zeros(2, H, 49, D, device=card)
    bias = torch.zeros(H, 49, 49, device=card)
    if D == 0:
        with pytest.raises(ValueError, match=f"head dim {D}"):
            wa.window_attention(q, q, q, bias, scale=1.0)
        with pytest.raises(ValueError, match=f"head dim {D}"):
            wa.window_attention_bwd(q, q, q, bias, None, q, scale=1.0)
        return
    _check_forward(*_inputs("none", 49, D, "float32", batch=2, seed=D, device=card))
    assert wa.window_attention.launches_by_route["stream"] == 2
    _check_backward(*_inputs("none", 49, D, "float32", batch=2, seed=D + 1, device=card))
    assert wa.window_attention_bwd.launches_by_route["stream"] == 2


@pytest.fixture
def streamed(monkeypatch):
    """Every call on the streamed kernels, whatever route the rule would
    take (it still refuses head dim 0)."""
    rule = wa._route
    monkeypatch.setattr(wa, "_route", lambda *a, **kw: rule(*a, **kw) and "stream")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,D,dtype", STREAM_CASES)
def test_streamed_kernels_and_the_log_sum_exp_match_plain_on_card(card, streamed, kind, N, D, dtype):
    """The streamed kernels, where the rule would take them or not: the
    forward with its log-sum-exp and without (equal bits), both bitwise
    repeatable, against the plain version and its log-sum-exp; then the
    backward fed that output and log-sum-exp against both plain backwards,
    bitwise repeatable; every launch on the streamed route."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, dtype, batch=2, seed=N + D + 17, device=card)
    scale = D ** -0.5
    wa.reset_launch_counts()
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    out2, lse2 = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    torch.cuda.synchronize()
    want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, alone)
    assert out.dtype == q.dtype and bool(torch.isfinite(out).all())
    err = (out.float() - want.float()).abs()
    if q.dtype == torch.float32:
        assert float(err.max()) <= F32_ATOL, float(err.max())
    else:
        assert bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()), float(err.max())
    lse_err = float((lse - want_lse).abs().max())
    assert lse_err <= F32_ATOL * max(1.0, float(want_lse.abs().max())), lse_err
    g = _upstream(q)
    got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, out=out, lse=lse)
    again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, out=out, lse=lse)
    torch.cuda.synchronize()
    wants = (wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask),
             wa.window_attention_plain_bwd_lse(q, k, v, bias, ids, out, lse, g, scale=scale, mask=mask))
    for want in wants:
        for name, a, b, w in zip(("dq", "dk", "dv", "dbias"), got, again, want):
            assert torch.equal(a, b), f"{name} is not bitwise repeatable"
            assert bool(torch.isfinite(a).all()), name
            tol = BWD_F32_RTOL if q.dtype == torch.float32 or name == "dbias" else BWD_BF16_RTOL
            e = float((a.float() - w.float()).abs().max() / w.float().abs().max())
            assert e <= tol, (name, e)
    assert wa.window_attention.launches_by_route == {"tile": 0, "wide": 0, "stream": 3}
    assert wa.window_attention_bwd.launches_by_route == {"tile": 0, "wide": 0, "stream": 2}
    assert wa.window_attention.launches_by_mode[_mode(ids, mask)] == 3
    assert wa.window_attention.launches_by_route_mode["stream"][_mode(ids, mask)] == 3
    assert wa.window_attention_bwd.launches_by_route_mode["stream"][_mode(ids, mask)] == 2


# (kind, N, D): head dims of one chunk at windows whose tiles do not fit a
# CTA (the backward's tiles 16 and 32 from N 849 and 433, the bf16 tile-64
# backward's window of K and V from N 817), which the rule sends to the
# streamed kernels; at N 864 the tile-16 forward fits but its backward does
# not, so the forward streams to store its log-sum-exp; N 900 a 30 x 30
# window with the shift mask
ONE_CHUNK_CASES = [("none", 450, 32), ("none", 864, 16), ("random", 900, 7), ("none", 900, 16),
                   ("shift", 900, 1), ("random", 1000, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,N,D", ONE_CHUNK_CASES)
def test_one_chunk_at_large_windows_streams_through_autograd_on_card(card, kind, N, D, dtype):
    """`window_attention` under autograd at one chunk of the head dim and a
    window the tiles do not take: the forward saves its log-sum-exp where
    the backward streams, each direction takes the rule's route (streamed
    at head dims up to 32, and in the bf16 backward at head dim 64) and
    `launches_by_route_mode` counts it, and out and the four gradients
    match the plain versions (the backward's tolerances of
    `_check_backward`), bitwise repeatable."""
    q, k, v, bias, ids, mask = _inputs(kind, N, D, dtype, batch=1, seed=N + D, device=card)
    g = _upstream(q)
    bf16 = dtype == "bfloat16"
    routes = {"fwd": wa._route(N, D, bf16, lse=wa._saves_lse(N, D, bf16, False)),
              "bwd": wa._route(N, D, bf16, backward=True)}
    assert routes == {"fwd": "tile" if D > 32 else "stream", "bwd": "tile" if D > 32 and not bf16 else "stream"}
    runs = []
    wa.reset_launch_counts()
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = wa.window_attention(*leaves, mask=mask, scale=D ** -0.5)
        out.backward(g)
        runs.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    mode = _mode(ids, mask)
    assert wa.window_attention.launches_by_route_mode[routes["fwd"]][mode] == 2
    assert wa.window_attention_bwd.launches_by_route_mode[routes["bwd"]][mode] == 2
    assert wa.window_attention.launches == wa.window_attention_bwd.launches == 2
    want = [wa.window_attention_plain(q, k, v, bias, mask=mask, scale=D ** -0.5)]
    want += wa.window_attention_plain_bwd(q, k, v, bias, None, g, scale=D ** -0.5, mask=mask)
    for name, a, b, w in zip(("out", "dq", "dk", "dv", "dbias"), *runs, want):
        assert torch.equal(a, b), f"{name} is not bitwise repeatable"
        assert bool(torch.isfinite(a).all()), name
        if name == "out":
            assert a.dtype == q.dtype
            err = (a.float() - w.float()).abs()
            if bf16:
                assert bool((err <= BF16_ATOL + BF16_RTOL * w.float().abs()).all()), float(err.max())
            else:
                assert float(err.max()) <= F32_ATOL, float(err.max())
        else:
            tol = BWD_BF16_RTOL if bf16 and name != "dbias" else BWD_F32_RTOL
            e = float((a.float() - w.float()).abs().max() / w.float().abs().max())
            assert e <= tol, (name, e)


# (N, D, dtype, direction): the largest head dim a chunked kernel takes and
# the next, which the rule sends to the streamed kernels
ROUTE_EDGES = [(343, 128, "float32", "forward"), (343, 129, "float32", "forward"),
               (49, 128, "float32", "backward"), (49, 129, "float32", "backward"),
               (343, 640, "bfloat16", "forward"), (343, 641, "bfloat16", "forward"),
               (343, 128, "bfloat16", "backward"), (343, 129, "bfloat16", "backward")]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,dtype,direction", ROUTE_EDGES)
def test_route_at_each_chunked_kernels_edge_on_card(card, N, D, dtype, direction):
    """The rule's route, unasked, at each chunked kernel's largest head dim
    (the chunked kernel) and the next (the streamed one), as
    `launches_by_route` counts it, the result held as above."""
    args = _inputs("region", N, D, dtype, batch=1, seed=N + D, device=card)
    (_check_forward if direction == "forward" else _check_backward)(*args)
    want = "wide" if D in (128, 640) else "stream"
    counts = (wa.window_attention if direction == "forward" else wa.window_attention_bwd).launches_by_route
    assert counts == {**dict.fromkeys(wa.ROUTES, 0), want: 2}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_geometry_is_the_same_at_every_head_dim_and_window_on_card(card, dtype):
    """Both streamed directions report 4 warps and `_stream_smem_bytes`
    (48 KB) at every head dim and window, in every mode, and at least two
    CTAs an SM."""
    bf16 = dtype == "bfloat16"
    for N in (4, 49, 144, 343, 1000):
        for D in (1, 64, 129, 648):
            for has_ids, has_mask in ((False, False), (True, False), (False, True)):
                for backward, geometry in ((False, wa._stream_fwd_geometry), (True, wa._stream_bwd_geometry)):
                    warps, smem, ctas = geometry(N, D, has_ids, has_mask, bf16, card.index)
                    assert (warps, smem) == (4, wa._stream_smem_bytes(backward)) and ctas >= 2, (N, D, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", SHAPES)
def test_forward_geometry_agrees_with_the_check_rule_on_card(card, N, D):
    """The shared memory the forward kernel reports is what `_check`
    reckons, in every mode and type; the window fits an SM."""
    for has_ids, has_mask, bf16 in ((False, False, False), (True, False, False), (False, True, False),
                                    (False, True, True)):
        warps, smem, ctas = wa._fwd_geometry(N, D, has_ids, has_mask, bf16, card.index)
        assert smem == wa._fwd_smem_bytes(N, D, bf16), (smem, wa._fwd_smem_bytes(N, D, bf16))
        assert 1 <= warps <= (16 if D > 32 else 8) and ctas >= 1


@pytest.mark.cuda
def test_geometry_refuses_a_window_that_cannot_fit_on_card(card):
    """N = 1000 at head dim 32 exceeds a CTA's shared memory in the
    forward (two buffers of K and V [1008, 32]), N = 450 in the backward
    (four [464, 33] f32 operands); the windows the port calls fit. Both
    tile-64 kernels stage 64 (a forward consumer warpgroup's, 3 to a CTA
    at N 343, 2 at N 450 and 1000) rows or keys and a ring of keys or rows
    at a time: the forward's shared memory does not grow with N but through
    its warpgroups, the backward's but for the region ids, and at least two
    backward CTAs share an SM. f32 MASK: the dK/dV kernel's, the larger, 4
    [64][64] (K and V hi and lo) + 2 ring slots of 4 [16][64] (Q, dO hi
    and lo), the term tile [16][64] and 2 [16] (lse, u) floats."""
    with pytest.raises(ValueError, match="does not fit"):
        wa._fwd_geometry(1000, 32, False, False, False, card.index)
    with pytest.raises(ValueError, match="does not fit"):
        wa._bwd_geometry(450, 32, False, False, False, card.index)
    for N in (450, 1000):  # 8 and 16 blocks of 64 rows: two consumer warpgroups a CTA
        warps, smem, ctas = wa._fwd_geometry(N, 64, False, False, False, card.index)
        assert (warps, smem) == (12, wa._fwd_smem_bytes(N, 64)) and smem < 214_448 and ctas >= 1
    assert wa._fwd_geometry(343, 64, False, False, False, card.index)[1] == 214_448
    tile64 = (4 * 64 * 64 + 2 * (4 * 16 * 64 + 16 * 64 + 2 * 16)) * 4
    for N in (49, 343, 450):
        warps, smem, ctas = wa._bwd_geometry(N, 64, False, True, False, card.index)
        assert (warps, smem) == (4, tile64) and ctas >= 2, (N, warps, smem, ctas)
    for N, D in SHAPES:
        warps, smem, ctas = wa._bwd_geometry(N, D, False, True, False, card.index)
        assert warps >= 1 and smem > 0 and ctas >= 1
