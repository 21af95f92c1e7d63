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
saves its inputs (as `_fused_attention_fwd` does) and recomputes the
softmax in the backward. On CUDA tensors the forward launches
`csrc/window_attention.cu` and the backward `csrc/window_attention_bwd.cu`;
on CPU tensors they run `window_attention_plain` and
`window_attention_plain_bwd`. Each kernel chooses its CTA's warps and
shared memory and reports them with its resident CTAs per SM
(`_fwd_geometry`, `_bwd_geometry`); `_window_groups` sizes both grids.
"""
from __future__ import annotations

import ctypes
import functools

import torch

HEAD_DIMS = (16, 32)  # the kernels' compiled head dims (SwinUNETR fs48, Swin-UNet 2D embed 96)
_MAX_SMEM_BYTES = 232_448  # per CTA on Hopper
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


def window_attention_plain(q, k, v, bias, region_ids=None, mask=None, *, scale: float):
    """Plain PyTorch version: einsum, + bias, + mask (from ids or dense),
    softmax, einsum. f32 arithmetic (f64 for f64 inputs), output in the
    dtype of q."""
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
    return torch.einsum("bhnm,bhmd->bhnd", p, v.to(ct)).to(q.dtype)


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


def _fwd_smem_bytes(N: int, D: int) -> int:
    """The forward kernel's shared memory per CTA (`smem_bytes` in
    `csrc/window_attention.cu`): two buffers of K and V [Np, D] and the
    region ids [Np] in f32, Np = N padded to a multiple of 16."""
    Np = -(-N // 16) * 16
    return 2 * (2 * Np * D + Np) * 4


def _check(q, k, v, bias, region_ids, mask, dout=None):
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
    if D not in HEAD_DIMS:
        raise ValueError(f"window_attention: head dim {D}, the kernels take {HEAD_DIMS}")
    # the forward's shared memory; the backward kernel reports its own (_bwd_geometry)
    if dout is None and _fwd_smem_bytes(N, D) > _MAX_SMEM_BYTES:
        raise ValueError(f"window_attention: window of {N} tokens does not fit shared memory")
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


def _window_groups(B: int, H: int, slots: int) -> tuple[int, int]:
    """(windows per CTA, number of window groups) of either kernel: the
    (group, head) grid fills the card's `slots` resident CTAs (CTAs per
    SM, from the compiled kernel's registers and the window's shared
    memory, times the SMs) once, every group non-empty."""
    groups = max(1, min(B, -(-slots // H)))
    per_cta = -(-B // groups)
    return per_cta, -(-B // per_cta)


def _geometry(lib, what: str, N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
              device: int) -> tuple[int, int, int]:
    """(warps per CTA, shared memory per CTA in bytes, resident CTAs per
    SM) of kernel `what` for windows of N tokens at head dim D, as the
    kernel chooses them and the CUDA runtime's occupancy of the compiled
    kernel gives. Raises ValueError when the window does not fit an SM."""
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
    """`_geometry` of the forward kernel."""
    from icl_tpu_torch.ops.build import load_window_attention

    return _geometry(load_window_attention(), "window_attention_fwd", N, D, has_ids, has_mask, bf16,
                     device)


@functools.cache
def _bwd_geometry(N: int, D: int, has_ids: bool, has_mask: bool, bf16: bool,
                  device: int) -> tuple[int, int, int]:
    """`_geometry` of the backward kernel."""
    from icl_tpu_torch.ops.build import load_window_attention_bwd

    return _geometry(load_window_attention_bwd(), "window_attention_bwd", N, D, has_ids, has_mask,
                     bf16, device)


@functools.cache
def _cached_grid(geometry, B: int, H: int, N: int, D: int, has_ids: bool, has_mask: bool,
                 bf16: bool, device: int) -> tuple[int, int]:
    _, _, ctas = geometry(N, D, has_ids, has_mask, bf16, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _window_groups(B, H, ctas * sms)


def _grid(geometry, q, region_ids, mask) -> tuple[int, int]:
    """`_window_groups` of a call on q [B, H, N, D] to the kernel whose
    geometry query is `geometry` (`_fwd_geometry` or `_bwd_geometry`),
    worked out once per call shape: the wrapper's host time sets the time
    per call at the smallest windows."""
    return _cached_grid(geometry, *q.shape, region_ids is not None, mask is not None,
                        q.dtype == torch.bfloat16, q.device.index)


def window_attention_fwd(q, k, v, bias, region_ids=None, mask=None, *, scale: float):
    """The forward alone, without autograd: the kernel on CUDA tensors
    (built on first use), `window_attention_plain` on CPU tensors."""
    mode = _mode(region_ids, mask)
    if _device_of(q) == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids, mask, scale=scale)
    _check(q, k, v, bias, region_ids, mask)
    from icl_tpu_torch.ops.build import load_window_attention

    lib = load_window_attention()
    B, H, N, D = q.shape
    per_cta, _ = _grid(_fwd_geometry, q, region_ids, mask)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.icl_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _ptr(region_ids),
            _ptr(mask), out.data_ptr(), B, H, N, D, _windows(B, region_ids, mask), per_cta,
            float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "window_attention")
    window_attention.launches += 1
    window_attention.launches_by_mode[mode] += 1
    return out


def window_attention_bwd(q, k, v, bias, region_ids, dout, *, scale: float, mask=None):
    """(dq, dk, dv, dbias) of the fused attention: the backward kernel on
    CUDA tensors (built on first use), `window_attention_plain_bwd` on
    CPU tensors. dbias is f32; the rest keep the dtype of q."""
    mode = _mode(region_ids, mask)
    if _device_of(q) == "cpu":
        return window_attention_plain_bwd(q, k, v, bias, region_ids, dout, scale=scale, mask=mask)
    _check(q, k, v, bias, region_ids, mask, dout)
    from icl_tpu_torch.ops.build import load_window_attention_bwd

    lib = load_window_attention_bwd()
    B, H, N, D = q.shape
    per_cta, groups = _grid(_bwd_geometry, q, region_ids, mask)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    part = torch.empty((groups, H, N, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.icl_window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(),
            _ptr(region_ids), _ptr(mask), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            part.data_ptr(), dbias.data_ptr(), B, H, N, D, _windows(B, region_ids, mask), per_cta,
            float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "window_attention_bwd")
    window_attention_bwd.launches += 1
    window_attention_bwd.launches_by_mode[mode] += 1
    return dq, dk, dv, dbias


class WindowAttentionFn(torch.autograd.Function):
    """The fused op under autograd (`_fused_attention`, a custom_vjp in the
    JAX package): saves q, k, v, bias and the region ids or the mask; its
    backward returns dq, dk, dv, dbias, and None for the ids and the mask,
    which is torch's spelling of the zero gradients the JAX backward
    returns for them (:346-347). Both directions run with autocast off, so
    the plain versions keep their f32 math."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region_ids, mask, scale):
        ctx.save_for_backward(q, k, v, bias, region_ids, mask)
        ctx.scale = scale
        with torch.autocast(q.device.type, enabled=False):
            return window_attention_fwd(q, k, v, bias, region_ids, mask, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, region_ids, mask = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dbias = window_attention_bwd(
                q, k, v, bias, region_ids, dout.contiguous().to(q.dtype), scale=ctx.scale,
                mask=mask)
        return dq, dk, dv, dbias, None, None, None


def window_attention(q, k, v, bias, region_ids=None, mask=None, *, scale: float):
    """Fused window attention, differentiable in q, k, v and bias. CUDA
    tensors go to the kernels; CPU tensors to the plain versions.
    `region_ids` and `mask` are mutually exclusive."""
    _device_of(q)
    _mode(region_ids, mask)
    return WindowAttentionFn.apply(q, k, v, bias, region_ids, mask, float(scale))


def reset_launch_counts() -> None:
    """Kernel launches since the last reset, forward and backward, by
    mask mode (the CPU path counts nothing)."""
    for fn in (window_attention, window_attention_bwd):
        fn.launches = 0
        fn.launches_by_mode = {"none": 0, "region": 0, "mask": 0}


reset_launch_counts()
