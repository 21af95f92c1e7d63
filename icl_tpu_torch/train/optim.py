"""Optimizer: torch SGD with momentum and weight decay, and a poly LR set
before every update (counterpart of `icl_tpu/train/optim.py`, its f32
path).

The reference's rule: the weight decay is added to the gradient before
the momentum buffer (g += wd * p; buf = m * buf + g; p -= lr * buf), for
every parameter, and update k (1-indexed) runs at
base_lr * (1 - (k - 1) / max_iterations) ** power.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def poly_lr_schedule(base_lr: float, max_iterations: int, power: float = 0.9) -> Callable[[int], float]:
    """lr(count) = base_lr * max(1 - count / max_iterations, 0) ** power,
    where `count` is the number of updates already made."""

    def schedule(count: int) -> float:
        return base_lr * max(1.0 - count / max_iterations, 0.0) ** power

    return schedule


class PolySGD:
    """`torch.optim.SGD` whose LR follows `poly_lr_schedule` of its update
    count. A parameter that got no gradient in a step (a head's last query
    projection, unused by the loss) gets a zero one, so that weight decay
    and momentum move it, as the JAX package's optax chain does."""

    def __init__(self, params: Iterable[torch.nn.Parameter], base_lr: float, max_iterations: int,
                 momentum: float = 0.9, weight_decay: float = 1e-4, power: float = 0.9):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = poly_lr_schedule(base_lr, max_iterations, power)
        self.optimizer = torch.optim.SGD(self.params, lr=base_lr, momentum=momentum,
                                         weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> float:
        """One update at lr(count); returns that lr."""
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.count += 1
        return lr
