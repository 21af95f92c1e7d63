"""Flags that the port's training CLIs share with their JAX counterparts:
`add_dispatch_flags` adds `--scan_steps` and `--dispatch_depth` (`Trainer`'s
step groups and dispatch window), `add_multi_process_flags` the ICL CLIs'
`--dist_coordinator`, `--num_processes` and `--process_id`
(`parallel.multihost.initialize_from_args`)."""
from __future__ import annotations

import argparse


def add_dispatch_flags(p: argparse.ArgumentParser) -> None:
    """`--scan_steps` (steps per group; on the card, replays of the step's
    captured CUDA graph) and `--dispatch_depth` (groups in flight before
    the host waits for the oldest), the JAX CLIs' names and defaults."""
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--dispatch_depth", type=int, default=1)


def add_multi_process_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' multi-process flags and defaults: one command per rank,
    with the same flags and its own `--process_id`, e.g.

        ... --dist_coordinator host0:1234 --num_processes 2 --process_id 0

    (env fallbacks ICL_TPU_COORDINATOR, ICL_TPU_NUM_PROCESSES,
    ICL_TPU_PROCESS_ID; host:port is where rank 0 listens)."""
    p.add_argument("--dist_coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
