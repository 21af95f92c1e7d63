"""The window-attention CUDA kernels against their plain PyTorch versions,
on the card only; every test here skips without one.

This file imports only torch, pytest and icl_tpu_torch: its oracles
are `window_attention_plain` and `window_attention_plain_bwd`, its region
ids and shift masks come from the port's own `window_region_ids_3d` and
`shifted_window_mask`. So it runs on a machine without JAX, with
tests/conftest.py (which imports JAX) left out:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_window_attention_card.py

Covered: forward and backward in NONE, REGION and MASK (the 2D shift mask
where N is a square, and a random dense mask), head dims 16 and 32, N in
{4, 49, 144, 343}, f32 and bf16, each bitwise equal across two runs; the
same at the paths' shapes, where a CTA walks several windows; and each
kernel's launch geometry (the forward's shared memory as `_check` reckons
it, and the refusal of a window that cannot fit).

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
CASES = [(kind, N, D, dtype) for kind in ("none", "region", "shift", "random") for N in sorted(GEOMETRY_3D)
         for D in wa.HEAD_DIMS for dtype in ("float32", "bfloat16") if kind != "shift" or N != 343]
# (kind, N, D, batch): shapes of the paths, with enough windows that a CTA
# walks several (2D stage 1, the 224^2 / window-7 stage 1, 3D stage 1, a
# 2 x 2 window)
SEVERAL_WINDOWS = {"shift144": ("shift", 144, 32, 128), "random49": ("random", 49, 32, 128),
                   "region343": ("region", 343, 16, 128), "none4": ("none", 4, 32, 1024)}
# every (N, D) the port's paths call, and the other head dim at each N
SHAPES = [(n, d) for n in (4, 49, 144, 216, 343) for d in wa.HEAD_DIMS]


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
        ids = torch.from_numpy(window_region_ids_3d(*GEOMETRY_3D[N])).to(device)
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


def _check_backward(q, k, v, bias, ids, mask):
    scale = q.shape[-1] ** -0.5
    g = torch.randn(q.shape, device=q.device, generator=torch.Generator(device=q.device).manual_seed(9))
    g = g.to(q.dtype)
    wa.reset_launch_counts()
    got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)
    again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)
    torch.cuda.synchronize()
    want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)
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
@pytest.mark.parametrize("N,D", SHAPES)
def test_forward_geometry_agrees_with_the_check_rule_on_card(card, N, D):
    """The shared memory the forward kernel reports is what `_check`
    reckons, in every mode and type; the window fits an SM."""
    for has_ids, has_mask, bf16 in ((False, False, False), (True, False, False), (False, True, False),
                                    (False, True, True)):
        warps, smem, ctas = wa._fwd_geometry(N, D, has_ids, has_mask, bf16, card.index)
        assert smem == wa._fwd_smem_bytes(N, D), (smem, wa._fwd_smem_bytes(N, D))
        assert 1 <= warps <= 8 and ctas >= 1


@pytest.mark.cuda
def test_geometry_refuses_a_window_that_cannot_fit_on_card(card):
    """N = 1000 at head dim 32 exceeds a CTA's shared memory in the
    forward (two buffers of K and V [1008, 32]), N = 450 in the backward
    (four [464, 33] f32 operands); the windows the port calls fit."""
    with pytest.raises(ValueError, match="does not fit"):
        wa._fwd_geometry(1000, 32, False, False, False, card.index)
    with pytest.raises(ValueError, match="does not fit"):
        wa._bwd_geometry(450, 32, False, False, False, card.index)
    for N, D in SHAPES:
        warps, smem, ctas = wa._bwd_geometry(N, D, False, True, False, card.index)
        assert warps >= 1 and smem > 0 and ctas >= 1
