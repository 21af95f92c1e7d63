"""Fused window attention: the CUDA kernel's wrapper and its plain version.

Counterpart of `icl_tpu/ops/pallas/window_attention.py`. Per (window,
head) it computes

    out = softmax(q.k^T * scale + bias[h] [+ M]) . v

where M = -100 wherever the shift-region ids of key and query differ
(`region_ids` [nW, N], window index = b % nW). Layout is that of
`window_attention_fused`: q, k, v [B*nW, H, N, D], bias [H, N, N].

`window_attention` launches the CUDA kernel (`csrc/window_attention.cu`)
on CUDA tensors and runs `window_attention_plain` on CPU tensors. It has
no backward yet and raises on a tensor that requires grad.
"""
from __future__ import annotations

import torch

HEAD_DIM = 16  # the kernel is compiled for this head dim only (SwinUNETR fs48)
_MAX_SMEM_BYTES = 232_448  # per CTA on Hopper


def mask_from_region_ids(region_ids: torch.Tensor) -> torch.Tensor:
    """[nW, N] region ids -> additive mask [nW, N, N] (0 / -100)."""
    diff = region_ids[:, None, :] - region_ids[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=region_ids.device)
    return torch.where(diff != 0, zero - 100.0, zero)


def window_attention_plain(q, k, v, bias, region_ids=None, *, scale: float):
    """Plain PyTorch version: einsum, + bias, + mask from ids, softmax,
    einsum. f32 arithmetic, output in the dtype of q."""
    B, H, N, _ = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    s = s + bias.float()[None]
    if region_ids is not None:
        nW = region_ids.shape[0]
        mask = mask_from_region_ids(region_ids.float())
        s = (s.view(B // nW, nW, H, N, N) + mask[None, :, None]).view(B, H, N, N)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.float()).to(q.dtype)


def _check(q, k, v, bias, region_ids):
    B, H, N, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attention: q dtype {q.dtype}, want float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"window_attention: {name} {tuple(t.shape)} {t.dtype} "
                             f"!= q {tuple(q.shape)} {q.dtype}")
    if bias.shape != (H, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} {bias.dtype}, "
                         f"want ({H}, {N}, {N}) float32")
    if D != HEAD_DIM:
        raise ValueError(f"window_attention: head dim {D}, the kernel takes {HEAD_DIM}")
    if (2 * N * (D + 1) + N) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"window_attention: window of {N} tokens does not fit shared memory")
    tensors = [q, k, v, bias]
    if region_ids is not None:
        nW = region_ids.shape[0]
        if region_ids.shape != (nW, N) or region_ids.dtype != torch.float32 or B % nW:
            raise ValueError(f"window_attention: region_ids {tuple(region_ids.shape)} "
                             f"{region_ids.dtype}, want (nW, {N}) float32 with nW | {B}")
        tensors.append(region_ids)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("window_attention: all inputs must be contiguous on one device")


def window_attention(q, k, v, bias, region_ids=None, *, scale: float):
    """Fused window attention. CUDA tensors go to the kernel (which is
    built on first use); CPU tensors go to `window_attention_plain`."""
    if any(t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError("window_attention has no backward yet; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
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
    if err != 0:
        raise RuntimeError("window_attention kernel launch failed: "
                           + lib.icl_cuda_error_string(err).decode())
    mode = "region" if region_ids is not None else "none"
    window_attention.launches += 1
    window_attention.launches_by_mode[mode] += 1
    return out


# Kernel launches since the last reset (the CPU path counts nothing).
window_attention.launches = 0
window_attention.launches_by_mode = {"none": 0, "region": 0}


def reset_launch_counts() -> None:
    window_attention.launches = 0
    window_attention.launches_by_mode = {"none": 0, "region": 0}
