"""The reductions of the data-parallel step, which XLA inserts in the JAX
package (there the step runs on the global batch, sharded over the data
axis).

Every rank computes the loss of the global batch: the sums that couple
rows (BatchNorm statistics, the labeled query mean, the Dice sums, the CE
and MSE means) are taken over the group by `all_reduce_sum`, whose backward
is an all-reduce too. So each rank's backward seeds the same global loss,
and a gradient that reaches a local tensor through an all-reduce is the sum
of the W ranks' seeds: every gradient of the local rows comes out W times
the global loss's, however many reductions it passed (each later one sums
per-rank partial gradients, which is right). `reduce_gradients` sums the
parameters' gradients over the ranks and divides by W once.

Every reduction here defaults to the data group (`mesh.data_group`): under
a (data, model) mesh the D ranks of one model index, which hold different
rows and the same shards; the ranks of one model group hold the same rows,
and summing over them would count each row M times. The model group's own
sum, of a replicated leaf whose gradient each model rank computes only in
part (the relative-position bias tables, of whose columns each rank reads
its heads'), is taken in the backward by `parallel.tensor.copy_to_model`.

Only `all_reduce` is used on tensors (gloo takes nothing else on CUDA
tensors), and `broadcast_object` broadcasts a host value's bytes, so the
group may be gloo or NCCL. With no group (`mesh.data_group()` None: one
process, or a mesh whose data axis has one rank) every function here is
the identity.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from icl_tpu_torch.parallel.mesh import data_group

# elements per flat gradient bucket (a larger gradient is its own bucket)
BUCKET_ELEMS = 1 << 25


def _group(group):
    return data_group() if group is None else group


def group_device(group: dist.ProcessGroup) -> torch.device:
    """Where a host-side collective of `group` keeps its tensor: the current
    card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dx = the sum of dy over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (default: the data group),
    differentiable; `x` itself with one process."""
    group = _group(group)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    group = _group(group)
    return 1 if group is None else dist.get_world_size(group)


def global_sum(x: torch.Tensor, dim: Sequence[int]) -> torch.Tensor:
    """`x.sum(dim)` over the rows of every rank (dim holds the batch axis)."""
    return all_reduce_sum(x.sum(dim=tuple(dim)))


def global_mean(x: torch.Tensor, dim: Optional[int] = None, keepdim: bool = False) -> torch.Tensor:
    """`x.mean(dim, keepdim)` over the rows of every rank, where `dim` (None:
    every axis) holds the batch axis; with one process `x.mean(...)` itself.
    Every rank holds the same number of rows."""
    group = data_group()
    if group is None:
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    w = dist.get_world_size(group)
    if dim is None:
        return all_reduce_sum(x.sum(), group) / (x.numel() * w)
    return all_reduce_sum(x.sum(dim, keepdim=keepdim), group) / (x.shape[dim] * w)


def _reduction_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each parameter's gradient by the mean of the ranks' gradients
    (their sum / W: the gradient of the global loss, see the module's
    docstring), by `reduce_mean_`. Parameters without a gradient are
    skipped (every rank has the same ones). With one process, nothing."""
    reduce_mean_([p.grad for p in params if p.grad is not None], group)


@torch.no_grad()
def reduce_mean_(tensors: list, group: Optional[dist.ProcessGroup] = None) -> None:
    """Replace each tensor by the mean over the ranks of its copies, in
    place, in flat buckets of up to BUCKET_ELEMS elements summed in f32
    (f64 for f64), one all-reduce each. With one process, nothing."""
    group = _group(group)
    if group is None:
        return
    w = dist.get_world_size(group)
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in tensors:
        if not buckets or size + g.numel() > BUCKET_ELEMS \
                or _reduction_dtype(g.dtype) != _reduction_dtype(buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel()
    for bucket in buckets:
        rdtype = _reduction_dtype(bucket[0].dtype)
        if len(bucket) == 1 and bucket[0].dtype == rdtype and bucket[0].is_contiguous():
            dist.all_reduce(bucket[0], group=group)
            bucket[0].div_(w)
            continue
        flat = torch.cat([g.reshape(-1).to(rdtype) for g in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(w)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def broadcast_object(obj, src: int, group: Optional[dist.ProcessGroup]):
    """`obj` of global rank `src` on every rank of `group`, pickled (a host
    value, such as a validation's metrics); `obj` itself with no group."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group, device=group_device(group))
    return box[0]


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    """Block until every rank of `group` (default: the data group) reaches
    this call: one all-reduce of one element, read on the host (on the
    current card for NCCL). With one process, nothing."""
    group = _group(group)
    if group is None:
        return
    t = torch.zeros(1, device=group_device(group))
    dist.all_reduce(t, group=group)
    t.item()
