"""The JAX training CLIs' flags that the port does not have. A port CLI
takes those of its JAX counterpart only to refuse any value but the
default, so that a JAX command line fails loudly instead of running
something else."""
from __future__ import annotations

import argparse
from typing import Sequence

# flag -> (type, the JAX CLI's default)
UNPORTED_FLAGS = {
    "input_mode": (str, "host"),
    "state_dtype": (str, "float32"),
    "checkpoint_interval": (int, 0),
    "scan_steps": (int, 1),
    "dispatch_depth": (int, 1),
    "dist_coordinator": (str, None),
    "num_processes": (int, None),
    "process_id": (int, None),
    "pretrained_ckpt": (str, None),
}
MULTI_PROCESS = ("dist_coordinator", "num_processes", "process_id")


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
