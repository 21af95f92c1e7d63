"""Optimizer: SGD with momentum and weight decay, and a poly LR set before
every update (counterpart of `icl_tpu/train/optim.py`).

The reference's rule: the weight decay is added to the gradient before
the momentum buffer (g += wd * p; buf = m * buf + g; p -= lr * buf), for
every parameter, and update k (1-indexed) runs at
base_lr * (1 - (k - 1) / max_iterations) ** power.

`state_dtype="bfloat16"` is the JAX package's bf16 train state
(`_sgd_bf16_state`, :73-120): bf16 parameters and momentum, the update in
f32, both stores stochastically rounded, by the fused kernel of
`ops/sgd_bf16.py` (one launch per leaf).

The step is safe to capture in a CUDA graph: the LR and the update count
live in 0-d device tensors, written before each update (`write_inputs`)
and read by the device work; the momentum buffers exist from the start,
and a parameter that got no gradient takes a zero gradient made once.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from icl_tpu_torch.ops.sgd_bf16 import sgd_bf16_update
from icl_tpu_torch.ops.sgd_bf16 import stochastic_round_bf16  # noqa: F401  (the JAX module's name)


def poly_lr_schedule(base_lr: float, max_iterations: int, power: float = 0.9) -> Callable[[int], float]:
    """lr(count) = base_lr * max(1 - count / max_iterations, 0) ** power,
    where `count` is the number of updates already made."""

    def schedule(count: int) -> float:
        return base_lr * max(1.0 - count / max_iterations, 0.0) ** power

    return schedule


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class PolySGD:
    """Torch-order SGD whose LR follows `poly_lr_schedule` of its update
    count. A parameter that got no gradient in a step (a head's last query
    projection, unused by the loss) moves by its weight decay and momentum,
    as the JAX package's optax chain moves it. With `state_dtype`
    "bfloat16" every parameter must be bf16; the momentum follows the
    parameters' dtype, and `seed` keys the stochastic rounding."""

    def __init__(self, params: Iterable[torch.nn.Parameter], base_lr: float, max_iterations: int,
                 momentum: float = 0.9, weight_decay: float = 1e-4, power: float = 0.9,
                 state_dtype: str = "float32", seed: int = 0):
        if state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype: {state_dtype!r}")
        self.params = [p for p in params if p.requires_grad]
        if state_dtype == "bfloat16" and any(p.dtype != torch.bfloat16 for p in self.params):
            raise ValueError("state_dtype bfloat16 needs bf16 parameters")
        self.schedule = poly_lr_schedule(base_lr, max_iterations, power)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.state_dtype, self.seed = state_dtype, seed
        self.momentum_buffers = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                                 for p in self.params]
        device = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.count_tensor = torch.zeros((), dtype=torch.int64, device=device)
        self._zero_grads: dict = {}
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def write_inputs(self) -> float:
        """Write lr(count) and the count into their device tensors (one
        fill each); returns that lr."""
        lr = self.schedule(self.count)
        self.lr.fill_(lr)
        self.count_tensor.fill_(self.count)
        return lr

    @torch.no_grad()
    def step(self) -> float:
        """One update at lr(count); returns that lr. Inside a CUDA graph
        capture the LR and count tensors are not written: the caller
        writes them before each replay."""
        lr = self.schedule(self.count) if _capturing(self.lr) else self.write_inputs()
        for i, p in enumerate(self.params):
            if p.grad is None:  # its zero gradient, made once (never inside a capture)
                if i not in self._zero_grads:
                    self._zero_grads[i] = torch.zeros_like(p)
                p.grad = self._zero_grads[i]
        if self.state_dtype == "bfloat16":
            for i, (p, buf) in enumerate(zip(self.params, self.momentum_buffers)):
                sgd_bf16_update(p, p.grad, buf, self.lr, self.count_tensor, self.momentum,
                                self.weight_decay, self.seed, i)
        else:
            self._step_f32()
        self.count += 1
        return lr

    def _step_f32(self) -> None:
        """g = grad + wd * p; buf = m * buf + g; p -= lr * buf, in one fused
        pass over all parameters (PyTorch's fused SGD, which reads the LR
        from its device tensor; the momentum buffers exist, so every update
        takes the m * buf + g branch, which from zero buffers gives g as the
        first step should)."""
        torch._fused_sgd_(self.params, [p.grad for p in self.params], self.momentum_buffers,
                          weight_decay=self.weight_decay, momentum=self.momentum, lr=self.lr,
                          dampening=0.0, nesterov=False, maximize=False, is_first_step=False)

    def state_dict(self) -> dict:
        """The momentum buffers by parameter index (torch SGD's layout), the
        state dtype and the rounding seed; the count is the trainer's."""
        return {"state": {i: {"momentum_buffer": b} for i, b in enumerate(self.momentum_buffers)},
                "state_dtype": self.state_dtype, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s momentum buffers into this optimizer's, in
        place (a captured CUDA graph keeps its pointers). A buffer of
        another dtype or shape, or another state dtype, raises."""
        saved = state.get("state_dtype", "float32")
        if saved != self.state_dtype:
            raise ValueError(f"the state's state_dtype is {saved!r}, this optimizer's "
                             f"{self.state_dtype!r}")
        bufs = state["state"]
        if len(bufs) != len(self.momentum_buffers):
            raise ValueError(f"the state holds {len(bufs)} momentum buffers, the optimizer "
                             f"{len(self.momentum_buffers)}")
        for i, buf in enumerate(self.momentum_buffers):
            src = bufs[i]["momentum_buffer"]
            if src.dtype != buf.dtype or src.shape != buf.shape:
                raise ValueError(f"momentum buffer {i}: {src.dtype} {tuple(src.shape)}, want "
                                 f"{buf.dtype} {tuple(buf.shape)}")
            buf.copy_(src)
        self.seed = state.get("seed", self.seed)
