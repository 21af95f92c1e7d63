"""Megatron tensor parallelism over the mesh's model axis (counterpart of
the GSPMD partitioning that `icl_tpu/parallel/mesh.py:shard_state` asks
XLA for): the four differentiable collectives of the model group, the
column- and row-parallel layers built from them, the sharding of a whole
model's layers (`shard_layers`), and the gather and slicing of its state
in the one-process layout.

The collectives over the M ranks of one model group:
  * `copy_to_model` (f): the identity forward, an all-reduce backward: a
    replicated tensor that each rank consumes with its own shard, so each
    rank's gradient holds only its shard's part;
  * `reduce_from_model` (g): an all-reduce forward, the identity backward:
    the row-parallel layer's partial sums;
  * `gather_from_model`: this rank's block along a dim, concatenated over
    the group; the backward keeps this rank's block of the gradient (not a
    sum: the consumers downstream are replicated, so every rank holds the
    whole gradient already);
  * `scatter_to_model`: this rank's block; the backward gathers.

Only `all_reduce` and `broadcast` are used: gloo, the one backend that can
put two ranks on one card, takes no `all_gather` of CUDA tensors, so a
gather is the all-reduce of a zero-filled buffer holding each rank's block
(exact: every element is one rank's value plus zeros). bf16 and f16
tensors travel in f32 and come back in their dtype.

A column-parallel layer holds the rows `Split.index` of the weight [out,
in] (and of the bias) and takes `copy_to_model` of its replicated input; a
row-parallel layer holds the columns `Split.index` of the weight, runs on
its rank's block of the input, sums the partial products with
`reduce_from_model` and adds the whole, replicated bias. Both keep the
reference key names (`weight`, `bias`), so the state_dict keys do not
change. A replicated parameter that a rank reads only in part (the
relative-position bias tables: each rank gathers its heads' columns) goes
through `copy_to_model`, whose backward sums its gradient over the model
group, so that every rank holds the whole gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Split:
    """Where a rank's shard of a leaf lies: along `dim`, of `full`
    elements there, cut into `pieces` equal parts (3 for qkv's q, k, v; 2
    for fc_kv's k, v; 1 else), rank `rank` of `size` holding the
    `rank`-th contiguous block of each part."""

    dim: int
    full: int
    pieces: int
    rank: int
    size: int

    @property
    def block(self) -> int:
        return self.full // (self.pieces * self.size)

    def runs(self) -> list[tuple[int, int, int]]:
        """(local start, global start, length) of each contiguous run."""
        part = self.full // self.pieces
        return [(p * self.block, p * part + self.rank * self.block, self.block)
                for p in range(self.pieces)]

    def index(self, device=None) -> torch.Tensor:
        """The global indices along `dim` of this rank's shard, in order."""
        return torch.cat([torch.arange(g, g + n, device=device) for _, g, n in self.runs()])

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor, contiguous."""
        return full.index_select(self.dim, self.index(full.device)).contiguous()


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """An attention layer on heads [start, stop) of the model group of
    `mesh`."""

    mesh: object
    start: int
    stop: int

    @property
    def heads(self) -> int:
        return self.stop - self.start


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x in a dtype gloo and NCCL sum exactly (f32 for
    bf16 and f16)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.contiguous().clone()


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    y = _wire(x)
    dist.all_reduce(y, group=mesh.model_group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    dim = dim % x.ndim
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * mesh.model_size
    wire = _wire(x)
    full = torch.zeros(shape, dtype=wire.dtype, device=x.device)
    full.narrow(dim, mesh.model_rank * n, n).copy_(wire)
    dist.all_reduce(full, group=mesh.model_group)
    return full.to(x.dtype)


def _block(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    dim = dim % x.ndim
    n = x.shape[dim] // mesh.model_size
    return x.narrow(dim, mesh.model_rank * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.dim, ctx.mesh), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _block(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.mesh), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x; its gradient summed over the model group."""
    return _Copy.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of x over the model group; its gradient as it comes."""
    return _Reduce.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The ranks' blocks of x concatenated along `dim`, in model-rank
    order; the gradient's block of this rank. x itself without a mesh."""
    return x if mesh is None else _Gather.apply(x, dim, mesh)


def scatter_to_model(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This rank's block of x along `dim`; the gradient gathered. x itself
    without a mesh."""
    return x if mesh is None else _Scatter.apply(x, dim, mesh)


def local_heads(table: torch.Tensor, tp: Optional[HeadShard], num_heads: int):
    """(the columns of a relative-position bias table [rows, heads] that
    this rank's heads read, their number): the table itself and
    `num_heads` without tensor parallelism; else this rank's columns of
    `copy_to_model(table)`, whose gradient is summed over the model
    group."""
    if tp is None:
        return table, num_heads
    return copy_to_model(table, tp.mesh)[:, tp.start:tp.stop], tp.heads


class _Parallel(nn.Module):
    """A layer holding its rank's shard of a whole layer's weight; `splits`
    maps each sharded parameter's name to its `Split`."""

    def __init__(self, whole: nn.Module, weight_split: Split, bias_split: Optional[Split], mesh):
        super().__init__()
        self.mesh = mesh
        self.splits = {"weight": weight_split}
        self.weight = nn.Parameter(weight_split.take(whole.weight.detach()))
        if whole.bias is None:
            self.register_parameter("bias", None)
        elif bias_split is not None:
            self.splits["bias"] = bias_split
            self.bias = nn.Parameter(bias_split.take(whole.bias.detach()))
        else:
            self.bias = nn.Parameter(whole.bias.detach().clone())


class ColumnParallelLinear(_Parallel):
    """`nn.Linear` holding the output rows `split.index` of the weight and
    bias: [B, ..., in] replicated -> [B, ..., out / M] of this rank."""

    def __init__(self, linear: nn.Linear, split: Split, mesh):
        super().__init__(linear, split, split, mesh)

    def forward(self, x):
        return F.linear(copy_to_model(x, self.mesh), self.weight, self.bias)


class RowParallelLinear(_Parallel):
    """`nn.Linear` holding the input columns `split.index` of the weight:
    [B, ..., in / M] of this rank -> [B, ..., out] summed over the model
    group, plus the replicated bias."""

    def __init__(self, linear: nn.Linear, split: Split, mesh):
        super().__init__(linear, split, None, mesh)

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight), self.mesh)
        return y if self.bias is None else y + self.bias


def _conv_args(conv: nn.Conv3d) -> dict:
    return dict(stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
                groups=conv.groups)


class ColumnParallelConv3d(_Parallel):
    """`nn.Conv3d` holding the output channels `split.index`: a replicated
    input -> this rank's channels."""

    def __init__(self, conv: nn.Conv3d, split: Split, mesh):
        super().__init__(conv, split, split, mesh)
        self.conv_args = _conv_args(conv)

    def forward(self, x):
        return F.conv3d(copy_to_model(x, self.mesh), self.weight, self.bias, **self.conv_args)


class RowParallelConv3d(_Parallel):
    """`nn.Conv3d` holding the input channels `split.index`: this rank's
    channels -> the whole output, summed over the model group, plus the
    replicated bias."""

    def __init__(self, conv: nn.Conv3d, split: Split, mesh):
        super().__init__(conv, split, None, mesh)
        self.conv_args = _conv_args(conv)

    def forward(self, x):
        y = reduce_from_model(F.conv3d(x, self.weight, None, **self.conv_args), self.mesh)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1, 1)


_PARALLEL = {(nn.Linear, 0): ColumnParallelLinear, (nn.Linear, 1): RowParallelLinear,
             (nn.Conv3d, 0): ColumnParallelConv3d, (nn.Conv3d, 1): RowParallelConv3d}


def shard_layers(model: nn.Module, plan: dict, mesh) -> None:
    """Replace every layer whose weight `plan` ({key: (dim, pieces)},
    `mesh.tp_plan`) splits by its parallel layer holding this rank's
    shard, and put each attention layer with a sharded `qkv` or `fc_kv` on
    its heads (`HeadShard`)."""
    modules = dict(model.named_modules())
    for key, (dim, pieces) in plan.items():
        if not key.endswith(".weight"):
            continue
        path = key[: -len(".weight")]
        whole = modules[path]
        if isinstance(whole, _Parallel):
            continue
        kind = nn.Linear if isinstance(whole, nn.Linear) else nn.Conv3d
        split = Split(dim, whole.weight.shape[dim], pieces, mesh.model_rank, mesh.model_size)
        parent_path, name = path.rsplit(".", 1) if "." in path else ("", path)
        setattr(modules[parent_path], name, _PARALLEL[kind, dim](whole, split, mesh))
        if name in ("qkv", "fc_kv"):
            attn = modules[parent_path]
            per = attn.num_heads // mesh.model_size
            attn.tp = HeadShard(mesh, mesh.model_rank * per, (mesh.model_rank + 1) * per)


def param_splits(model: nn.Module) -> dict:
    """{parameter name: `Split`} of the sharded parameters of `model`."""
    out = {}
    for path, m in model.named_modules():
        for name, split in getattr(m, "splits", {}).items():
            out[f"{path}.{name}" if path else name] = split
    return out


def tp_mesh(model: nn.Module):
    """The mesh of a sharded model, or None."""
    return next((m.mesh for m in model.modules() if isinstance(m, _Parallel)), None)


def is_sharded_module(m: nn.Module) -> bool:
    """Whether `m` computes on this rank's shard only: a parallel layer or
    an attention layer on its heads."""
    return isinstance(m, _Parallel) or getattr(m, "tp", None) is not None


def _broadcast_gather(local: torch.Tensor, split: Split, mesh, device) -> torch.Tensor:
    """The whole tensor of a shard, bit for bit: each rank's shard
    broadcast in turn over the model group as bytes (any dtype), put at
    its indices."""
    shape = list(local.shape)
    shape[split.dim] = split.full
    full = torch.empty(shape, dtype=local.dtype, device=device)
    ranks = mesh.model_ranks()
    for r in range(mesh.model_size):
        buf = local.to(device).contiguous() if r == mesh.model_rank else torch.empty_like(
            local, device=device, memory_format=torch.contiguous_format)
        dist.broadcast(buf.reshape(-1).view(torch.uint8), src=ranks[r], group=mesh.model_group)
        other = dataclasses.replace(split, rank=r)
        full.index_copy_(split.dim, other.index(device), buf)
    return full


def gather_tensors(tensors: dict, splits: dict, mesh, device) -> dict:
    """{name: whole tensor} of {name: this rank's tensor}: the sharded ones
    (`splits`) gathered over the model group, the others as they are;
    every rank of the model group must call it. `device` is where the
    collective runs (the CPU for gloo, the card for NCCL); the result lies
    there."""
    out = {}
    for name, t in tensors.items():
        split = splits.get(name)
        out[name] = t if split is None else _broadcast_gather(t, split, mesh, device)
    return out


def shard_tensors(tensors: dict, splits: dict) -> dict:
    """{name: this rank's shard} of {name: whole tensor} (`Split.take`)."""
    return {k: splits[k].take(v) if k in splits else v for k, v in tensors.items()}
