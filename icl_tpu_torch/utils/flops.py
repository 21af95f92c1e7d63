"""Analytic matmul and convolution FLOPs of a function, counted while it
runs (counterpart of `icl_tpu/utils/flops.py`, which walks a traced jaxpr).

`torch.utils.flop_counter.FlopCounterMode` counts the textbook formulas of
every mm, bmm, addmm, baddbmm, convolution and convolution backward that
runs inside it (2MNK; 2 * output elements * Cin/groups * kernel size), so a
step counted this way includes its backward and the recompute of a
checkpointed block, as the JAX count includes remat. Everything else
(elementwise, reductions, gathers) is left out, as in JAX.

The port's own CUDA kernels run outside PyTorch's dispatcher, so their
wrappers add their FLOPs by formula at each launch (`add_kernel_flops`):
the window-attention forward 4*B*H*N^2*D, its backward 10*B*H*N^2*D (the
scores recomputed, then dV, dP, dQ and dK), and the stochastic-rounding
SGD update none. On the CPU the wrappers run their plain versions, whose
matmuls the mode counts, to the same totals.

The functions run what they count: `analytic_step_flops(step, batch)` takes
a real training step (the trainer counts its first eager step, before any
CUDA graph capture).

Given a tensor-parallel model, a count also keeps apart (`.sharded`) the
FLOPs run inside its sharded modules (`parallel.tensor.is_sharded_module`),
forward and backward, as FlopCounterMode's module tracker places them:
each rank runs its share of those and the whole of the rest.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

_OPEN: list = []  # the counts in progress, innermost last


def add_kernel_flops(flops: float) -> None:
    """A kernel wrapper's launch: add `flops` to every count in progress."""
    for counter in _OPEN:
        counter.kernel_flops += flops
        if counter.in_shard():
            counter.sharded += flops


def _signature(args, out) -> str:
    ins = ",".join("x".join(map(str, a.shape)) for a in args[:2] if torch.is_tensor(a))
    outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,)) if torch.is_tensor(o)]
    return f"({ins})->" + ",".join("x".join(map(str, o.shape)) for o in outs)


class _Counter(FlopCounterMode):
    """FlopCounterMode's totals, one row per (op, shape signature) beside
    them, and the kernels' FLOPs from their wrappers."""

    def __init__(self, sharded_names: frozenset = frozenset()):
        super().__init__(display=False)
        self.rows: dict = {}
        self.kernel_flops = 0.0
        self.sharded_names = sharded_names
        self.sharded = 0.0

    def in_shard(self) -> bool:
        """Whether the op running now runs inside a sharded module."""
        return bool(self.sharded_names) and not self.sharded_names.isdisjoint(self.mod_tracker.parents)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            flops = self.flop_registry[func_packet](*args, **kwargs, out_val=out)
            self.flop_counts["Global"][func_packet] += flops
            if self.in_shard():
                self.sharded += flops
            row = self.rows.setdefault((str(func_packet), _signature(args, out)),
                                       {"flops": 0.0, "count": 0})
            row["flops"] += flops
            row["count"] += 1
        return out

    @property
    def total(self) -> float:
        return float(self.get_total_flops()) + self.kernel_flops


def _sharded_names(model) -> frozenset:
    """The module tracker's names of `model`'s sharded modules (the root's
    class name, then the module path)."""
    if model is None:
        return frozenset()
    from icl_tpu_torch.parallel.tensor import is_sharded_module

    root = type(model).__name__
    return frozenset(f"{root}.{path}" for path, m in model.named_modules()
                     if path and is_sharded_module(m))


@contextlib.contextmanager
def counting(model=None):
    """A count of the matmul and convolution FLOPs run inside the block
    (`.total`, `.rows`), the kernels' included; given a tensor-parallel
    `model` (called inside the block as the root module), also those run
    in its sharded modules (`.sharded`)."""
    counter = _Counter(_sharded_names(model))
    _OPEN.append(counter)
    try:
        with counter:
            yield counter
    finally:
        _OPEN.remove(counter)


def count_matmul_flops(fn: Callable, *args, **kwargs) -> float:
    """The analytic FLOPs of one call `fn(*args, **kwargs)`, which runs."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.total


def analytic_step_flops(step_fn: Callable, *args) -> float:
    """The executed FLOPs of one training step (forward, backward and every
    recompute): the step runs, and updates its state, as any step does."""
    return count_matmul_flops(step_fn, *args)


def analytic_fwd_flops(fn: Callable, *args, **kwargs) -> float:
    """The forward's FLOPs, without gradients. A training step costs about 3x
    this (the forward, and the gradients by input and by weight)."""
    with torch.no_grad():
        return count_matmul_flops(fn, *args, **kwargs)


def per_op_flops(fn: Callable, *args, **kwargs) -> list[dict]:
    """One row {"op", "sig", "flops", "count"} per (op, shape signature) of
    one call of `fn`, by FLOPs descending; the kernels' launches as one row
    "kernels"."""
    with counting() as c:
        fn(*args, **kwargs)
    out = [{"op": op, "sig": sig, **row} for (op, sig), row in c.rows.items()]
    if c.kernel_flops:
        out.append({"op": "kernels", "sig": "", "flops": c.kernel_flops, "count": 0})
    return sorted(out, key=lambda r: -r["flops"])
