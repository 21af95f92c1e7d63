"""Tracing and step timing (counterpart of `icl_tpu/utils/profiling.py`):
`trace` records the host's and the card's activity with torch.profiler and
writes a Chrome trace (chrome://tracing, Perfetto); `StepTimer` meters
steps per second after a warm-up."""
from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (the CPU, and the card where CUDA is available)
    and write `logdir/trace_<pid>_<n>.json`; yields the profiler, whose
    `trace_path` names the file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        prof.trace_path = None
        yield prof
    prof.export_chrome_trace(path)
    prof.trace_path = path


class StepTimer:
    """Wall-clock steps per second, the first `warmup_steps` ticks left out."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0 = None

    def tick(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._count <= self.warmup_steps:
            return 0.0
        return (self._count - self.warmup_steps) / (time.perf_counter() - self._t0)
