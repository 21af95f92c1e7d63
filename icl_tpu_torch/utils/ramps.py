"""Ramp-up schedules (a copy of `icl_tpu/utils/ramps.py`, the reference's
`code/utils/ramps.py`). The reference's AMOS script computes a sigmoid
ramp of its consistency weight and never applies it; the CLIs use fixed
weights, as both packages do."""
from __future__ import annotations

import numpy as np


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 (1 - t)^2) for t = current / rampup_length clipped to [0, 1]."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def linear_rampup(current: float, rampup_length: float) -> float:
    """current / rampup_length, clipped to [0, 1]."""
    if rampup_length == 0:
        return 1.0
    return float(np.clip(current, 0.0, rampup_length) / rampup_length)


def cosine_rampdown(current: float, rampdown_length: float) -> float:
    """0.5 (cos(pi current / rampdown_length) + 1), for current in [0,
    rampdown_length] (arXiv:1608.03983)."""
    if not 0 <= current <= rampdown_length:
        raise ValueError(f"current {current} outside [0, {rampdown_length}]")
    return float(0.5 * (np.cos(np.pi * current / rampdown_length) + 1))
