"""Multi-process launch and the rank-local input pipeline (counterpart of
`icl_tpu/parallel/multihost.py`).

Every process runs the same seeded sampler and makes the same global batch,
in the reference's [labeled..., unlabeled...] layout, then keeps its own
rows (`host_local_batches`), so the batches do not depend on the number of
processes. The JAX package keeps a contiguous block of the global rows per
host and slices `batch[:labeled_bs]` on the global array; the port's step
runs on the rows of its rank, so each rank holds both branches: rank r
holds labeled block r followed by unlabeled block r, and the concatenation
over the ranks, per branch, is the global batch. That needs `labeled_bs`
and `batch_size - labeled_bs` divisible by the number of processes (the JAX
package needs only `batch_size`). Under a (data, model) mesh the rows and
the per-rank seeds go by the data rank and size (`mesh.data_group`): the
ranks of one model group hold the same rows and draw the same dropout
masks, or their replicas would drift apart.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from icl_tpu_torch.data.pipeline import Prefetcher
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.parallel.collectives import group_device
from icl_tpu_torch.parallel.mesh import data_group

# covers rank 0's validation, during which the other ranks wait in a barrier
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def host_rows(batch_size: int, labeled_bs: int, process_index: int,
              process_count: int) -> np.ndarray:
    """The global rows of this process: labeled block `process_index` of
    the first `labeled_bs` rows, then the same block of the unlabeled rows.
    Raises ValueError when a branch does not split over `process_count`."""
    unlabeled = batch_size - labeled_bs
    if labeled_bs % process_count or unlabeled % process_count:
        raise ValueError(
            f"labeled_bs {labeled_bs} and batch_size - labeled_bs {unlabeled} must both be "
            f"divisible by the {process_count} processes: each rank holds an equal share of "
            "each branch")
    lab, unl = labeled_bs // process_count, unlabeled // process_count
    return np.concatenate([np.arange(process_index * lab, (process_index + 1) * lab),
                           labeled_bs + np.arange(process_index * unl, (process_index + 1) * unl)])


def host_slice(batch: dict, labeled_bs: int, process_index: int, process_count: int) -> dict:
    """This process's rows (`host_rows`) of every array of `batch`."""
    rows = host_rows(len(next(iter(batch.values()))), labeled_bs, process_index, process_count)
    return {k: v[rows] for k, v in batch.items()}


def host_local_batches(global_batches: Iterator[dict], labeled_bs: int, process_index: int,
                       process_count: int) -> Iterator[dict]:
    """Filter a seeded global batch stream down to this process's rows.
    Every process must use the same sampler seed."""
    for b in global_batches:
        yield host_slice(b, labeled_bs, process_index, process_count)


def _backend(device: torch.device, num_processes: int) -> tuple[str, str]:
    """NCCL when every rank has a card of its own, else gloo; and why."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if cards < num_processes:
        return "gloo", f"{num_processes} ranks share {cards} card(s); NCCL takes one rank per card"
    return "nccl", f"one card per rank ({cards} cards)"


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def initialize_from_args(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         rows: Optional[Sequence[int]] = None) -> tuple[int, int]:
    """`torch.distributed.init_process_group` from the CLI flags, with the
    JAX package's env-var fallbacks (ICL_TPU_COORDINATOR,
    ICL_TPU_NUM_PROCESSES, ICL_TPU_PROCESS_ID); returns (process_index,
    process_count). One process is a no-op. Before it connects it checks
    that `rows` (batch_size, labeled_bs) split over the processes
    (`host_rows`) and that `device` exists, so a bad command line fails on
    every rank instead of leaving the others waiting. The backend is NCCL
    when each rank has its own card and gloo when ranks share a card or run
    on the CPU (rank 0 prints the choice); a failure is raised, never
    retried with another backend. The group is destroyed at exit."""
    coordinator = coordinator or os.environ.get("ICL_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("ICL_TPU_NUM_PROCESSES", "1") or 1)
    if process_id is None:
        process_id = int(os.environ.get("ICL_TPU_PROCESS_ID", "0") or 0)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} of {num_processes} processes")
    if rows is not None:
        host_rows(*rows, process_id, num_processes)
    if num_processes == 1:
        return 0, 1
    if not coordinator:
        raise ValueError("--dist_coordinator (host:port) is required when num_processes > 1")
    dev = resolve_device(device)
    backend, why = _backend(dev, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=GROUP_TIMEOUT)
    atexit.register(_shutdown)
    if process_id == 0:
        print(f"[multihost] {num_processes} processes, backend {backend}: {why}", flush=True)
    return process_id, num_processes


def all_gather_case_metrics(local_metric_cal: list, group: Optional[dist.ProcessGroup] = None):
    """Per-class lists of per-case (dice, hd95) from every rank, rank by
    rank (the JAX package's `process_allgather` layout); every rank must
    hold the same number of cases. One process: the list itself. Built from
    one all-reduce of a zero-padded [ranks, classes, cases, 2] f64 tensor
    (on the current card for NCCL)."""
    group = data_group() if group is None else group
    if group is None:
        return local_metric_cal
    local = torch.as_tensor(np.asarray(local_metric_cal, np.float64))
    device = group_device(group)
    gathered = torch.zeros((dist.get_world_size(group),) + tuple(local.shape), dtype=torch.float64,
                           device=device)
    gathered[dist.get_rank(group)] = local.to(device)
    dist.all_reduce(gathered, group=group)
    gathered = gathered.cpu().numpy()
    return [[tuple(row) for proc in gathered for row in proc[c]] for c in range(gathered.shape[1])]


def launch_batches(global_batches: Iterator[dict], labeled_bs: int, pin_memory: bool = False):
    """The CLIs' launch contract: a `Prefetcher` over this process's rows of
    the global batches under multi-process (`host_local_batches`), over the
    global batches with one process."""
    group = data_group()
    if group is not None:
        global_batches = host_local_batches(global_batches, labeled_bs, dist.get_rank(group),
                                            dist.get_world_size(group))
    return Prefetcher(global_batches, pin_memory=pin_memory)
