"""Why both window-attention kernels split every product into three TF32
MMAs, and the launch geometry they are given.

The tensor cores take f32 only as TF32 (10 mantissa bits). Each kernel
is emulated here on the CPU with every product computed from
TF32-rounded operands (exact products, f32 sums, as the tensor cores do):
once as plain TF32 and once in the 3xTF32 split a.b = a_lo.b_hi +
a_hi.b_lo + a_hi.b_hi (hi = tf32(a), lo = tf32(a - hi)), against the
same function in f64.
- The forward, two products, at a 2D Swin-UNet shape with the shift mask
  and at a SwinUNETR shape with region ids: the split and plain f32
  products stay within the kernel's f32 tolerance (1e-5 absolute,
  chip_smoke.py's F32_ATOL); plain TF32 misses it about a hundredfold.
- The backward, five products, at the 2D shape: the split stays within
  1e-5 of each gradient's largest magnitude (chip_smoke.py's
  BWD_F32_RTOL) and plain TF32 does not.

The geometry: `_check` takes every window size and head dim the port
calls, and sends a window the tile forward cannot hold to the streamed
kernels, and `_window_groups`
covers every window with non-empty groups. Each kernel reports its own
warps and shared memory (a query of the compiled kernel), so that report
is checked on the card (tests/test_torch_window_attention_card.py).
"""
import numpy as np
import pytest
import torch

from icl_tpu_torch.models.swin2d import shifted_window_mask
from icl_tpu_torch.models.swinunetr import window_region_ids_3d
from icl_tpu_torch.ops import window_attention as wa
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

F32_ATOL = 1e-5
BWD_F32_RTOL = 1e-5
# every (N, D) the port's paths call: SwinUNETR fs48 (N 343, 216 at D 16) and
# Swin-UNet embed 96 (N 144 at window 12, 49 at window 7, D 32; N 4 where a
# stage of 2 x 2 tokens shrinks the window to 2), and the other head dim at
# each N
SHAPES = [(n, d) for n in (4, 49, 144, 216, 343) for d in wa.HEAD_DIM_TILES]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b over the last two dims with TF32 operands, f32 sums."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_fwd(q, k, v, bias, mask, scale, product):
    """The forward kernel's dataflow in f32, both products through `_mm`
    (`product` "3xtf32" or "tf32"), or as f32 products ("f32")."""
    mm = torch.matmul if product == "f32" else lambda a, b: _mm(a, b, product == "3xtf32")
    B, H, N, _ = q.shape
    nW = mask.shape[0]
    s = mm(q, k.transpose(-1, -2)) * scale + bias[None]
    s = (s.view(B // nW, nW, H, N, N) + mask[None, :, None]).view(B, H, N, N)
    return mm(torch.softmax(s, dim=-1), v)


def _emulated_bwd(q, k, v, bias, mask, g, scale, split):
    """The kernel's dataflow in f32, every product through `_mm`."""
    B, H, N, _ = q.shape
    nW = mask.shape[0]
    s = _mm(q, k.transpose(-1, -2), split) * scale + bias[None]
    s = (s.view(B // nW, nW, H, N, N) + mask[None, :, None]).view(B, H, N, N)
    p = torch.softmax(s, dim=-1)
    dp = _mm(g, v.transpose(-1, -2), split)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (_mm(ds, k, split) * scale, _mm(ds.transpose(-1, -2), q, split) * scale,
            _mm(p.transpose(-1, -2), g, split), ds.sum(0))


def _rel_errs(got, want):
    return {name: float((a.double() - b).abs().max() / b.abs().max())
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want)}


@pytest.fixture(scope="module")
def stage_inputs():
    """[8, 6, 144, 32] with the shift mask of a 24 x 24 grid of window 12
    (nW = 4), inputs from a seeded numpy generator, and the f64 backward."""
    rng = np.random.default_rng(0)
    B, H, N, D = 8, 6, 144, 32
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((H, N, N)).astype(np.float32))
    mask = torch.from_numpy(shifted_window_mask(24, 24, 12, 6))
    scale = D ** -0.5
    want = wa.window_attention_plain_bwd(*(t.double() for t in (q, k, v, bias)), None, g.double(),
                                         scale=scale, mask=mask.double())
    return (q, k, v, bias, mask, g, scale), want


@pytest.fixture(scope="module", params=["2d_shift_mask", "3d_region_ids"])
def fwd_inputs(request):
    """[8, 6, 144, 32] with the shift mask of a 24 x 24 grid of window 12
    (nW = 4), or [8, 3, 343, 16] with the region ids of a shifted 14^3
    grid of window 7 (nW = 8) as their dense mask; inputs from a seeded
    numpy generator, and the f64 forward."""
    rng = np.random.default_rng(1)
    if request.param == "2d_shift_mask":
        (B, H, N, D), mask = (8, 6, 144, 32), shifted_window_mask(24, 24, 12, 6)
    else:
        ids = torch.from_numpy(window_region_ids_3d((14, 14, 14), (7, 7, 7), (3, 3, 3)))
        (B, H, N, D), mask = (8, 3, 343, 16), wa.mask_from_region_ids(ids).numpy()
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, N, D)).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((H, N, N)).astype(np.float32))
    mask, scale = torch.from_numpy(mask), D ** -0.5
    want = wa.window_attention_plain(*(t.double() for t in (q, k, v, bias)), mask=mask.double(), scale=scale)
    return (q, k, v, bias, mask, scale), want


@pytest.mark.parametrize("product", ["3xtf32", "tf32", "f32"])
def test_forward_tf32_split_keeps_the_f32_tolerance(fwd_inputs, product):
    """3xTF32 and f32 products within 1e-5 of the f64 forward (about
    1.2e-6); one TF32 product misses it (about 1.4e-3)."""
    args, want = fwd_inputs
    err = float((_emulated_fwd(*args, product=product).double() - want).abs().max())
    if product == "tf32":
        assert err > 10 * F32_ATOL, err
    else:
        assert err <= F32_ATOL, err


@pytest.mark.parametrize("split", [True, False], ids=["3xtf32", "tf32"])
def test_tf32_split_keeps_the_f32_tolerance(stage_inputs, split):
    args, want = stage_inputs
    errs = _rel_errs(_emulated_bwd(*args, split=split), want)
    if split:
        assert all(e <= BWD_F32_RTOL for e in errs.values()), errs
    else:
        assert all(e > BWD_F32_RTOL for e in errs.values()), errs


def test_f32_products_meet_the_tolerance_the_split_is_held_to(stage_inputs):
    """The yardstick: plain f32 products sit within the same tolerance."""
    (q, k, v, bias, mask, g, scale), want = stage_inputs
    got = wa.window_attention_plain_bwd(q, k, v, bias, None, g, scale=scale, mask=mask)
    errs = _rel_errs(got, want)
    assert all(e <= BWD_F32_RTOL for e in errs.values()), errs


@pytest.mark.parametrize("N,D", SHAPES)
def test_check_and_geometry_take_every_window_the_port_calls(N, D):
    nW, H = 2, 3
    q = torch.zeros(nW, H, N, D)
    wa._check(q, q, q, torch.zeros(H, N, N), None, torch.zeros(nW, N, N), q)
    wa._check(q, q, q, torch.zeros(H, N, N), None, torch.zeros(nW, N, N))
    for B, slots in ((686, 264), (512, 264), (8, 264), (1, 1), (7, 3)):
        per_cta, groups = wa._window_groups(B, H, slots)
        assert groups * per_cta >= B > (groups - 1) * per_cta  # every window once, no group empty
        assert groups <= max(1, -(-slots // H))  # one wave of the resident CTAs


# (B, H, N, D, slots): the tile-64 shapes of the paths (fs192's inference
# stage 1 and training stages, the 2D stage 1 at 3 heads of 64, a short
# window) at the resident CTAs of 132 SMs (one an SM at 2 or 3 consumer
# warpgroups, two at one), and fewer slots than blocks
TILE64_GRIDS = [(1372, 3, 343, 64, 132), (686, 3, 343, 40, 132), (128, 6, 343, 64, 132), (16, 12, 343, 64, 132),
                (4, 24, 216, 64, 132), (512, 3, 144, 64, 132), (512, 3, 49, 64, 264), (1024, 3, 4, 33, 264),
                (7, 3, 343, 64, 5)]


@pytest.mark.parametrize("B,H,N,D,slots", TILE64_GRIDS)
def test_tile64_grid_is_one_wave_of_row_blocks(B, H, N, D, slots):
    """The tile-64 forward grid: a CTA per block of 64 G rows (G consumer
    warpgroups, `_fwd64_groups`), head and window group; every window of
    every block once, no group empty, and the blocks of all groups within
    one wave of the resident CTAs (at least one group)."""
    rows = 64 * wa._fwd64_groups(N)
    per_cta, groups = wa._grid_of(B, H, N, D, slots, rows)
    ctas_per_group = H * -(-N // rows)
    assert rows * -(-N // rows) == -(-N // 64) * 64  # no block of 64 rows is empty
    assert groups * per_cta >= B > (groups - 1) * per_cta
    assert groups == 1 or groups * ctas_per_group <= slots
    if (B, H, N) == (1372, 3, 343):  # fs192 stage 1: 2 CTAs of 192 rows a head, 22 groups of 63 windows
        assert (rows, per_cta, groups) == (192, 63, 22)


@pytest.mark.parametrize("B,H,N,D,slots", [(686, 3, 343, 16, 264), (512, 3, 144, 32, 264), (8, 3, 49, 32, 264)])
def test_tile16_and_32_grid_is_a_group_per_head(B, H, N, D, slots):
    """Tiles 16 and 32 keep a CTA per (window group, head)."""
    assert wa._grid_of(B, H, N, D, slots) == wa._window_groups(B, H, slots)


def test_check_refuses_a_window_the_forward_cannot_take():
    """A window the tile-32 forward cannot hold (two buffers of K and V
    [1008, 32] exceed a CTA's shared memory), which `_check` refused before
    the streamed kernels, now takes the streamed forward, whose shared
    memory does not grow with N."""
    N, D = 1000, 32
    q = torch.zeros(1, 1, N, D)
    assert wa._fwd_smem_bytes(N, D) > wa._MAX_SMEM_BYTES and not wa._fwd_fits(N, D)
    assert wa._check(q, q, q, torch.zeros(1, N, N), None, None) == "stream"
