"""The data-parallel group (counterpart of `icl_tpu/parallel/mesh.py:
create_mesh`).

The JAX package lays its devices out as a ('data', 'model') mesh and lets
XLA insert the collectives; no JAX CLI uses a model axis (`launch_batches`
makes `model=1`). The port runs one process per rank, each holding a full
replica, and reduces explicitly (`collectives`) over the group that
`torch.distributed.init_process_group` made (`multihost.initialize_from_args`).
Without such a group, or with a group of one process, there is nothing to
reduce: every function of `collectives` is then the identity and the step
is the one-process step, bit for bit. Tensor parallelism (`model > 1`) is
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from icl_tpu_torch.device import resolve_device


def data_group() -> Optional[dist.ProcessGroup]:
    """The default process group when one of more than one process is
    initialised, else None (one process: nothing to reduce)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data axis over the processes: the group (None for one process),
    this process's rank, the number of processes and this rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def create_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The data-parallel mesh over every process of the initialised group
    (one process when none is), with the JAX signature: `data` -1 or the
    number of processes, `model` 1. `device` as `resolve_device` takes it
    (None: the CUDA card); with more than one process a CUDA device without
    an index becomes this rank's, `cuda:{rank % device count}` (ranks
    beyond the cards share them)."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism (the JAX package's model axis, "
            "DEFAULT_PARAM_RULES and the GSPMD window attention) is not ported; the port "
            "runs data parallelism only")
    group = data_group()
    size = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if data not in (-1, size):
        raise ValueError(f"data={data}: the group holds {size} processes")
    device = resolve_device(device)
    if size > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, rank, size, device)
