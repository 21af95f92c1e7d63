"""Flags that the port's training CLIs share with their JAX counterparts:
`add_dispatch_flags` adds the JAX CLIs' `--scan_steps` and
`--dispatch_depth` (`Trainer`'s step groups and dispatch window), and
`parse_args_refusing` takes the flags the port does not have only to
refuse any value but the default, so that a JAX command line fails loudly
instead of running something else."""
from __future__ import annotations

import argparse
from typing import Sequence

# flag -> (type, the JAX CLI's default)
UNPORTED_FLAGS = {
    "dist_coordinator": (str, None),
    "num_processes": (int, None),
    "process_id": (int, None),
}
MULTI_PROCESS = ("dist_coordinator", "num_processes", "process_id")


def add_dispatch_flags(p: argparse.ArgumentParser) -> None:
    """`--scan_steps` (steps per group; on the card, replays of the step's
    captured CUDA graph) and `--dispatch_depth` (groups in flight before
    the host waits for the oldest), the JAX CLIs' names and defaults."""
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--dispatch_depth", type=int, default=1)


def parse_args_refusing(p: argparse.ArgumentParser, argv, names: Sequence[str],
                        reason: str) -> argparse.Namespace:
    """Add the flags `names` of UNPORTED_FLAGS to `p`, parse `argv`, and
    exit through `p.error` if any of them is given a value other than its
    default; `reason` says what the port does instead."""
    for name in names:
        kind, default = UNPORTED_FLAGS[name]
        p.add_argument(f"--{name}", type=kind, default=default)
    args = p.parse_args(argv)
    refused = [f"--{n}" for n in names if getattr(args, n) != UNPORTED_FLAGS[n][1]]
    if refused:
        p.error(f"not ported: {' '.join(refused)} ({reason})")
    return args
