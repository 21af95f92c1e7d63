"""LR schedules of the update count (counterpart of
`icl_tpu/train/schedulers.py`, whose optax schedules these are, as Python
functions returning floats): the poly decay the CLIs use, linear warm-up
then cosine annealing (LinearWarmupCosineAnnealingLR), warm-up then
cosine (WarmupCosineSchedule), warm-up then poly, and warm-up then
multi-step. Any of them drives `PolySGD(schedule=...)`, which writes the
LR of each update into its device tensor before the step, so a schedule
also works under CUDA-graph replay. The JAX schedules compute in f32;
these in Python floats (within 1e-6 of them).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch

from icl_tpu_torch.train.optim import PolySGD, poly_lr_schedule

Schedule = Callable[[int], float]

__all__ = ["poly_lr_schedule", "warmup_cosine_schedule", "linear_warmup_cosine_annealing",
           "warmup_poly_schedule", "warmup_multistep_schedule", "sgd_with_schedule"]


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           cycles: float = 0.5) -> Schedule:
    """WarmupCosineSchedule: a linear 0 -> 1 warm-up, then a cosine decay
    over the remaining progress (floored at 0)."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / max(1.0, warmup_steps)
        progress = (count - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))

    return schedule


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int, max_epochs: int,
                                   warmup_start_lr: float = 0.0, eta_min: float = 0.0) -> Schedule:
    """LinearWarmupCosineAnnealingLR: linear from `warmup_start_lr` to
    `base_lr`, then cosine from `base_lr` to `eta_min`."""

    def schedule(count: int) -> float:
        if count < warmup_epochs:
            return warmup_start_lr + (base_lr - warmup_start_lr) * count / max(1.0, warmup_epochs)
        progress = (count - warmup_epochs) / max(1.0, max_epochs - warmup_epochs)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule


def _warmup_factor(count: int, warmup_steps: int, warmup_factor: float) -> float:
    alpha = count / max(1.0, warmup_steps)
    return warmup_factor * (1 - alpha) + alpha


def warmup_poly_schedule(base_lr: float, max_iterations: int, warmup_steps: int = 0,
                         warmup_factor: float = 1e-3, power: float = 0.9) -> Schedule:
    """WarmupPolyLR: a linear warm-up from `warmup_factor`, then the poly
    decay."""
    poly = poly_lr_schedule(base_lr, max_iterations, power)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * _warmup_factor(count, warmup_steps, warmup_factor)
        return poly(count)

    return schedule


def warmup_multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                              warmup_steps: int = 0, warmup_factor: float = 1e-3) -> Schedule:
    """WarmupMultiStepLR: `gamma` to the power of the milestones passed,
    times the warm-up factor during the warm-up."""
    milestones = sorted(milestones)

    def schedule(count: int) -> float:
        lr = base_lr * gamma ** sum(count >= m for m in milestones)
        if count < warmup_steps:
            return lr * _warmup_factor(count, warmup_steps, warmup_factor)
        return lr

    return schedule


def sgd_with_schedule(params: Iterable[torch.nn.Parameter], schedule: Schedule,
                      momentum: float = 0.9, weight_decay: float = 1e-4, **kwargs) -> PolySGD:
    """Torch-order SGD (weight decay into the gradient, then momentum) at
    `schedule`'s LR of each update (the JAX package's optax chain);
    `kwargs` as `PolySGD` takes them (`state_dtype`, `grad_accum`)."""
    return PolySGD(params, 0.0, 1, momentum, weight_decay, schedule=schedule, **kwargs)
