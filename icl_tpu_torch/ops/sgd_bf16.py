"""The fused SGD update of a bf16 train state: the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of `icl_tpu/train/optim.py:_sgd_bf16_state` (XLA ops in the
JAX package, not a Pallas kernel). For one bf16 leaf, in f32:

    g32 = g + wd * p;  b32 = m * buf + g32;  p32 = p - lr * b32

then buf and p are stored to bf16 with stochastic rounding: 16 random bits
added below the bf16 mantissa of the f32 bit pattern, then truncated
(`stochastic_round_bf16`). The random bits are a pure function of (seed,
update count, leaf index, stream, element index): Philox4x32-10 with key
(seed low, seed high) and counter (element index // 4, count, leaf, 0);
word i % 4 of its output holds element i's 16 bits for buf (stream 0,
low half) and for p (stream 1, high half). The kernel
(`csrc/sgd_bf16.cu`) and `sgd_bf16_plain` compute the same function, bit
for bit. `lr` and `count` are 0-d device tensors, read by the kernel where
it runs, so that a captured CUDA graph takes each replay's values.

A shard of a leaf (tensor parallelism) draws the dithers of its elements'
indices in the whole leaf, so that the update of a shard is the slice of
the whole leaf's update bit for bit: local element i is global element
`offset + (i // cols) * stride + i % cols` (`index_map`), a block of rows
with cols == stride, a block of columns else.
"""
from __future__ import annotations

from typing import Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * c for a 32-bit constant m and int64
    c in [0, 2^32): m is split into 16-bit halves, so that each product
    stays below 2^48 and the whole computation inside int64."""
    p_lo = (m & 0xFFFF) * c
    p_hi = (m >> 16) * c
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int) -> list[torch.Tensor]:
    """Philox4x32-10 of the counters (int64 tensors of 32-bit values, or
    ints) under the key (k0, k1); four int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def index_map(n: int, offset: int = 0, cols: Optional[int] = None,
              stride: Optional[int] = None) -> tuple[int, int, int]:
    """(offset, cols, stride) of a shard of n elements: the whole leaf's
    (0, n, n) by default; cols == stride without `stride`."""
    cols = n if cols is None else cols
    stride = cols if stride is None else stride
    if cols <= 0 or stride < cols or offset < 0:
        raise ValueError(f"sgd_bf16: index map offset {offset}, cols {cols}, stride {stride}")
    return offset, cols, stride


def dither_bits(n: int, seed: int, count: int, leaf: int, device=None, offset: int = 0,
                cols: Optional[int] = None, stride: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 16-bit dithers (int64, in [0, 2^16)) of the n elements of leaf
    `leaf` at update `count`: (stream 0, for buf; stream 1, for p). With an
    index map (`index_map`), those of the global elements the n local
    elements stand for."""
    offset, cols, stride = index_map(n, offset, cols, stride)
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    if offset == 0 and cols == stride:
        groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
        zero = torch.zeros_like(groups)
        words = philox4x32_10(groups & _MASK32, zero + (count & _MASK32), zero + (leaf & _MASK32),
                              groups >> 32, *key)
        w = torch.stack(words, dim=1).reshape(-1)[:n]
    else:  # each element's own group and word
        i = torch.arange(n, dtype=torch.int64, device=device)
        gi = offset + torch.div(i, cols, rounding_mode="floor") * stride + i % cols
        groups = gi >> 2
        zero = torch.zeros_like(groups)
        words = torch.stack(philox4x32_10(groups & _MASK32, zero + (count & _MASK32),
                                          zero + (leaf & _MASK32), groups >> 32, *key), dim=1)
        w = words.gather(1, (gi & 3)[:, None])[:, 0]
    return w & 0xFFFF, w >> 16


def stochastic_round_bf16(x: torch.Tensor, dither: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 by adding `dither` (int64 values in [0, 2^16), the shape
    of x) below the bf16 mantissa of x's bit pattern, then truncating:
    E[result] == x, and a bf16-representable x is kept exactly."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _MASK32
    trunc = (bits + dither.view(x.shape)) & 0xFFFF0000
    trunc = torch.where(trunc >= 1 << 31, trunc - (1 << 32), trunc)
    return trunc.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def sgd_bf16_plain(p: torch.Tensor, g: Optional[torch.Tensor], buf: torch.Tensor, lr: torch.Tensor,
                   count: torch.Tensor, momentum: float, weight_decay: float, seed: int,
                   leaf: int, offset: int = 0, cols: Optional[int] = None,
                   stride: Optional[int] = None) -> None:
    """The plain PyTorch version: updates p and buf in place, each product
    and sum in f32 rounded on its own, as the kernel does; the dithers of
    the index map's global elements (`index_map`)."""
    wd, m = torch.tensor(weight_decay, dtype=torch.float32), torch.tensor(momentum, dtype=torch.float32)
    p32 = p.float()
    g32 = (g.float() if g is not None else torch.zeros_like(p32)) + wd.to(p.device) * p32
    b32 = m.to(p.device) * buf.float() + g32
    p32 = p32 - lr.to(torch.float32) * b32
    d_buf, d_p = dither_bits(p.numel(), seed, int(count), leaf, device=p.device, offset=offset,
                             cols=cols, stride=stride)
    buf.copy_(stochastic_round_bf16(b32, d_buf))
    p.copy_(stochastic_round_bf16(p32, d_p))


def _check(p, g, buf, lr, count) -> None:
    for name, t in (("p", p), ("buf", buf)) + ((("g", g),) if g is not None else ()):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != p.device:
            raise ValueError(f"sgd_bf16: {name} must be a contiguous bf16 tensor on {p.device}, "
                             f"got {t.dtype} on {t.device}, contiguous {t.is_contiguous()}")
        if t.shape != p.shape:
            raise ValueError(f"sgd_bf16: {name} has shape {tuple(t.shape)}, p {tuple(p.shape)}")
    if lr.dtype != torch.float32 or lr.dim() != 0 or lr.device != p.device:
        raise ValueError(f"sgd_bf16: lr must be a 0-d f32 tensor on {p.device}")
    if count.dtype != torch.int64 or count.dim() != 0 or count.device != p.device:
        raise ValueError(f"sgd_bf16: count must be a 0-d int64 tensor on {p.device}")


def sgd_bf16_update(p: torch.Tensor, g: Optional[torch.Tensor], buf: torch.Tensor,
                    lr: torch.Tensor, count: torch.Tensor, momentum: float, weight_decay: float,
                    seed: int, leaf: int, offset: int = 0, cols: Optional[int] = None,
                    stride: Optional[int] = None) -> None:
    """One update of the bf16 leaf p and its momentum buf, in place: the
    kernel on CUDA tensors (built on first use), `sgd_bf16_plain` on CPU
    tensors. g None means no gradient (taken as 0). `offset`, `cols` and
    `stride` map a shard's elements to the whole leaf's (`index_map`)."""
    _check(p, g, buf, lr, count)
    offset, cols, stride = index_map(p.numel(), offset, cols, stride)
    if p.device.type == "cpu":
        return sgd_bf16_plain(p, g, buf, lr, count, momentum, weight_decay, seed, leaf, offset,
                              cols, stride)
    if p.device.type != "cuda":
        raise ValueError(f"sgd_bf16: tensors on {p.device}; want cuda or cpu")
    from icl_tpu_torch.ops.build import load_sgd_bf16

    lib = load_sgd_bf16()
    with torch.cuda.device(p.device):
        err = lib.icl_sgd_bf16(p.data_ptr(), g.data_ptr() if g is not None else None,
                               buf.data_ptr(), p.numel(), lr.data_ptr(), count.data_ptr(),
                               float(momentum), float(weight_decay), int(seed) & ((1 << 64) - 1),
                               int(leaf), offset, cols, stride,
                               torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"sgd_bf16: launch failed: {lib.icl_cuda_error_string(err).decode()}")
    sgd_bf16_update.launches += 1


def reset_launch_counts() -> None:
    """Kernel launches since the last reset (the CPU path counts nothing)."""
    sgd_bf16_update.launches = 0


reset_launch_counts()
