"""Fused window attention: the CUDA kernels' wrappers, the autograd
Function around them, and their plain versions.

Counterpart of `icl_tpu/ops/pallas/window_attention.py`. Per (window,
head) the forward computes

    out = softmax(q.k^T * scale + bias[h] [+ M]) . v

where M = -100 wherever the shift-region ids of key and query differ
(`region_ids` [nW, N], window index = b % nW). Layout is that of
`window_attention_fused`: q, k, v [B*nW, H, N, D], bias [H, N, N].

`window_attention` is differentiable through `WindowAttentionFn`, which
saves its inputs (as `_fused_attention_fwd` does) and recomputes the
softmax in the backward. On CUDA tensors the forward launches
`csrc/window_attention.cu` and the backward `csrc/window_attention_bwd.cu`;
on CPU tensors they run `window_attention_plain` and
`window_attention_plain_bwd`.
"""
from __future__ import annotations

import torch

HEAD_DIM = 16  # the kernels are compiled for this head dim only (SwinUNETR fs48)
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


def window_attention_plain(q, k, v, bias, region_ids=None, *, scale: float):
    """Plain PyTorch version: einsum, + bias, + mask from ids, softmax,
    einsum. f32 arithmetic (f64 for f64 inputs), output in the dtype of q."""
    B, H, N, _ = q.shape
    ct = _compute_dtype(q)
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(ct), k.to(ct)) * scale
    s = s + bias.to(ct)[None]
    if region_ids is not None:
        nW = region_ids.shape[0]
        mask = mask_from_region_ids(region_ids.float())
        s = (s.view(B // nW, nW, H, N, N) + mask[None, :, None]).view(B, H, N, N)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.to(ct)).to(q.dtype)


def _chunk_scores(qc, kc, bias, region_ids, b0: int, scale: float) -> torch.Tensor:
    """f32 scores [b, H, N, N] of the windows b0 .. b0 + len(qc) - 1."""
    s = torch.einsum("bhnd,bhmd->bhnm", qc, kc) * scale + bias.to(qc.dtype)[None]
    if region_ids is not None:
        widx = torch.arange(b0, b0 + qc.shape[0], device=qc.device) % region_ids.shape[0]
        s = s + mask_from_region_ids(region_ids.float()[widx]).to(s.dtype)[:, None]
    return s


def window_attention_plain_bwd(q, k, v, bias, region_ids, dout, *, scale: float,
                               chunk_bytes: int = _CHUNK_BYTES):
    """Plain PyTorch backward, a copy of `_fused_attention_bwd`: recompute
    the softmax over chunks of windows (chunk * H * N * N * 4 bytes <=
    `chunk_bytes`), ds = p * (dp - sum(dp * p)), dbias = sum of ds over
    windows. Returns (dq, dk, dv in the dtype of q, dbias in f32, or f64
    for f64 inputs)."""
    B, H, N, _ = q.shape
    ct = _compute_dtype(q)
    chunk = max(1, min(B, chunk_bytes // max(1, H * N * N * 4)))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.zeros((H, N, N), dtype=ct, device=q.device)
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        qc, kc, vc, gc = (t[sl].to(ct) for t in (q, k, v, dout))
        p = torch.softmax(_chunk_scores(qc, kc, bias, region_ids, b0, scale), dim=-1)
        dv[sl] = torch.einsum("bhnm,bhnd->bhmd", p, gc).to(q.dtype)
        dp = torch.einsum("bhnd,bhmd->bhnm", gc, vc)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dq[sl] = (torch.einsum("bhnm,bhmd->bhnd", ds, kc) * scale).to(q.dtype)
        dk[sl] = (torch.einsum("bhnm,bhnd->bhmd", ds, qc) * scale).to(q.dtype)
        dbias += ds.sum(0)
    return dq, dk, dv, dbias


def _check(q, k, v, bias, region_ids, dout=None):
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
    if D != HEAD_DIM:
        raise ValueError(f"window_attention: head dim {D}, the kernel takes {HEAD_DIM}")
    smem_floats = (4 * N * (D + 1) + 4 * N) if dout is not None else (2 * N * (D + 1) + N)
    if smem_floats * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"window_attention: window of {N} tokens does not fit shared memory")
    tensors = [q, k, v, bias] + ([dout] if dout is not None else [])
    if region_ids is not None:
        nW = region_ids.shape[0]
        if region_ids.shape != (nW, N) or region_ids.dtype != torch.float32 or B % nW:
            raise ValueError(f"window_attention: region_ids {tuple(region_ids.shape)} "
                             f"{region_ids.dtype}, want (nW, {N}) float32 with nW | {B}")
        tensors.append(region_ids)
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


def window_attention_fwd(q, k, v, bias, region_ids=None, *, scale: float):
    """The forward alone, without autograd: the kernel on CUDA tensors
    (built on first use), `window_attention_plain` on CPU tensors."""
    if _device_of(q) == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids, scale=scale)
    _check(q, k, v, bias, region_ids)
    from icl_tpu_torch.ops.build import load_window_attention

    lib = load_window_attention()
    B, H, N, D = q.shape
    nW = region_ids.shape[0] if region_ids is not None else B
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.icl_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            region_ids.data_ptr() if region_ids is not None else None, out.data_ptr(),
            B, H, N, D, nW, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "window_attention")
    mode = "region" if region_ids is not None else "none"
    window_attention.launches += 1
    window_attention.launches_by_mode[mode] += 1
    return out


def _bwd_groups(B: int, H: int, device: torch.device) -> tuple[int, int]:
    """(windows per CTA, number of window groups): about two CTAs per SM
    over the (group, head) grid, every group non-empty."""
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, min(B, -(-target // H)))
    per_cta = -(-B // groups)
    return per_cta, -(-B // per_cta)


def window_attention_bwd(q, k, v, bias, region_ids, dout, *, scale: float):
    """(dq, dk, dv, dbias) of the fused attention: the backward kernel on
    CUDA tensors (built on first use), `window_attention_plain_bwd` on
    CPU tensors. dbias is f32; the rest keep the dtype of q."""
    if _device_of(q) == "cpu":
        return window_attention_plain_bwd(q, k, v, bias, region_ids, dout, scale=scale)
    _check(q, k, v, bias, region_ids, dout)
    from icl_tpu_torch.ops.build import load_window_attention_bwd

    lib = load_window_attention_bwd()
    B, H, N, D = q.shape
    nW = region_ids.shape[0] if region_ids is not None else B
    per_cta, groups = _bwd_groups(B, H, q.device)
    bias_t = bias.transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    part = torch.empty((groups, H, N, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.icl_window_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), bias.data_ptr(),
            bias_t.data_ptr(), region_ids.data_ptr() if region_ids is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(), dbias.data_ptr(),
            B, H, N, D, nW, per_cta, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "window_attention_bwd")
    mode = "region" if region_ids is not None else "none"
    window_attention_bwd.launches += 1
    window_attention_bwd.launches_by_mode[mode] += 1
    return dq, dk, dv, dbias


class WindowAttentionFn(torch.autograd.Function):
    """The fused op under autograd (`_fused_attention`, a custom_vjp in the
    JAX package): saves q, k, v, bias and the region ids; its backward
    returns dq, dk, dv, dbias and no grad for the ids. Both directions
    run with autocast off, so the plain versions keep their f32 math."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region_ids, scale):
        ctx.save_for_backward(q, k, v, bias, region_ids)
        ctx.scale = scale
        with torch.autocast(q.device.type, enabled=False):
            return window_attention_fwd(q, k, v, bias, region_ids, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, region_ids = ctx.saved_tensors
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv, dbias = window_attention_bwd(
                q, k, v, bias, region_ids, dout.contiguous().to(q.dtype), scale=ctx.scale)
        return dq, dk, dv, dbias, None, None


def window_attention(q, k, v, bias, region_ids=None, *, scale: float):
    """Fused window attention, differentiable in q, k, v and bias. CUDA
    tensors go to the kernels; CPU tensors to the plain versions."""
    _device_of(q)
    return WindowAttentionFn.apply(q, k, v, bias, region_ids, float(scale))


def reset_launch_counts() -> None:
    """Kernel launches since the last reset, forward and backward, by
    mask mode (the CPU path counts nothing)."""
    for fn in (window_attention, window_attention_bwd):
        fn.launches = 0
        fn.launches_by_mode = {"none": 0, "region": 0}


reset_launch_counts()
