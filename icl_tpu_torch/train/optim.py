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

`grad_accum` k > 1 is optax.MultiSteps' contract (the JAX trainer wraps
its SGD in it, `icl_tpu/train/trainer.py:76-79`): micro-step n (0-indexed
in its window) folds its gradient into an accumulator of the parameter's
dtype as acc + (g - acc) / (n + 1), the running mean in optax's rounding;
parameters and momentum stay as they are until the k-th micro-step, which
takes one SGD update of the mean and clears the accumulator. The LR
schedule counts updates, not micro-steps.

Under data parallelism (`parallel.mesh.data_group`) the update's gradient
is reduced over the ranks here, at the update and nowhere else: each
step's gradient with `grad_accum` 1, the window's mean with k > 1 (the
same in exact arithmetic as reducing each micro-step's gradient, and one
all-reduce per window instead of k). A parameter's zero gradient adds
nothing to the sum. With one process the reduction is nothing.

`schedule` takes any schedule of the update count (`train/schedulers.py`);
the poly LR is the default.

Under tensor parallelism a parameter is this rank's shard of a leaf
(`parallel.tensor.Split`, in `shards`): its momentum, accumulator and
update live with the shard, and the bf16 update draws the dithers of the
shard's elements' indices in the whole leaf (`ops.sgd_bf16.index_map`,
one launch per contiguous run), so that it is the slice of the whole
leaf's update bit for bit.

The step is safe to capture in a CUDA graph: the LR, the update count and
the micro-step's divisor live in 0-d device tensors, written before each
step (`write_inputs`) and read by the device work; the momentum buffers
and the accumulators exist from the start, and a parameter that got no
gradient takes a zero gradient made once. Which of a window's two kinds of
micro-step runs (accumulate only, or accumulate and update) is the host's
`micro` index, so a caller captures one graph of each
(`Trainer.graph_step`).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch

from icl_tpu_torch.ops.sgd_bf16 import sgd_bf16_update
from icl_tpu_torch.ops.sgd_bf16 import stochastic_round_bf16  # noqa: F401  (the JAX module's name)
from icl_tpu_torch.parallel.collectives import reduce_mean_


def poly_lr_schedule(base_lr: float, max_iterations: int, power: float = 0.9) -> Callable[[int], float]:
    """lr(count) = base_lr * max(1 - count / max_iterations, 0) ** power,
    where `count` is the number of updates already made."""

    def schedule(count: int) -> float:
        return base_lr * max(1.0 - count / max_iterations, 0.0) ** power

    return schedule


def shard_runs(split, tensors: tuple) -> list:
    """[(the tensors' views of one contiguous run, offset, cols, stride)]
    of a leaf or its shard (`split`): the whole leaf is one run mapped to
    itself; a block of rows (dim 0) one run per piece, each a block of the
    whole leaf's elements; a block of columns (dim 1) one run whose rows
    stride over the whole leaf's."""
    n = tensors[0].numel()
    if split is None:
        return [(tensors, 0, n, n)]
    inner = math.prod(tensors[0].shape[split.dim + 1:])
    if split.dim == 0:
        return [(tuple(t.narrow(0, local, length) for t in tensors), start * inner,
                 length * inner, length * inner) for local, start, length in split.runs()]
    if split.dim != 1 or split.pieces != 1:
        raise ValueError(f"sgd_bf16: a shard along dim {split.dim} in {split.pieces} pieces")
    (_, start, length), = split.runs()
    return [(tensors, start * inner, length * inner, split.full * inner)]


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class PolySGD:
    """Torch-order SGD whose LR follows `schedule` (default
    `poly_lr_schedule(base_lr, max_iterations, power)`) of its update count.
    A parameter that got no gradient in a step (a head's last query
    projection, unused by the loss) moves by its weight decay and momentum,
    as the JAX package's optax chain moves it. With `state_dtype`
    "bfloat16" every parameter must be bf16; the momentum follows the
    parameters' dtype, and `seed` keys the stochastic rounding.
    `grad_accum` > 1 accumulates that many micro-steps per update (f32 or
    f64 states only, as in the JAX package). `shards` gives, parameter by
    parameter, the `parallel.tensor.Split` of a tensor-parallel shard or
    None."""

    def __init__(self, params: Iterable[torch.nn.Parameter], base_lr: float, max_iterations: int,
                 momentum: float = 0.9, weight_decay: float = 1e-4, power: float = 0.9,
                 state_dtype: str = "float32", seed: int = 0, grad_accum: int = 1,
                 schedule: Optional[Callable[[int], float]] = None,
                 shards: Optional[Sequence] = None):
        if state_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"state_dtype: {state_dtype!r}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum {grad_accum}: want >= 1")
        if state_dtype == "bfloat16" and grad_accum > 1:
            raise ValueError("state_dtype='bfloat16' requires grad_accum=1")
        params = list(params)
        shards = [None] * len(params) if shards is None else list(shards)
        self.params = [p for p in params if p.requires_grad]
        self.shards = [sh for p, sh in zip(params, shards) if p.requires_grad]
        if state_dtype == "bfloat16" and any(p.dtype != torch.bfloat16 for p in self.params):
            raise ValueError("state_dtype bfloat16 needs bf16 parameters")
        self.schedule = schedule or poly_lr_schedule(base_lr, max_iterations, power)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.state_dtype, self.seed = state_dtype, seed
        self.momentum_buffers = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                                 for p in self.params]
        self.grad_accum = grad_accum
        self.accumulators = ([torch.zeros_like(p, memory_format=torch.contiguous_format)
                              for p in self.params] if grad_accum > 1 else [])
        device = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.count_tensor = torch.zeros((), dtype=torch.int64, device=device)
        self.divisor = torch.ones((), dtype=torch.float32, device=device)  # micro + 1
        self._zero_grads: dict = {}
        self.count = 0  # updates taken
        self.micro = 0  # micro-steps taken in the current window (0 when grad_accum is 1)

    @property
    def updates_now(self) -> bool:
        """Whether the next `step` takes an update (the window's last
        micro-step), which the host knows without reading the device."""
        return self.micro == self.grad_accum - 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def write_inputs(self) -> float:
        """Write lr(count), the count and the micro-step's divisor into
        their device tensors (one fill each); returns that lr, the LR of the
        update the next step belongs to."""
        lr = self.schedule(self.count)
        self.lr.fill_(lr)
        self.count_tensor.fill_(self.count)
        self.divisor.fill_(self.micro + 1)
        return lr

    def advance(self) -> None:
        """The host's counters after one step (`step` calls it; a replay of
        a captured step, which runs no Python, needs its caller to)."""
        if self.updates_now:
            self.count += 1
        self.micro = (self.micro + 1) % self.grad_accum

    @torch.no_grad()
    def step(self) -> float:
        """One step at lr(count): an update, or with `grad_accum` > 1 a
        micro-step (its gradient accumulated; the update at the window's
        last); returns the LR of the update it belongs to. Inside a CUDA
        graph capture the device inputs are not written: the caller writes
        them before each replay."""
        lr = self.schedule(self.count) if _capturing(self.lr) else self.write_inputs()
        for i, p in enumerate(self.params):
            if p.grad is None:  # its zero gradient, made once (never inside a capture)
                if i not in self._zero_grads:
                    self._zero_grads[i] = torch.zeros_like(p)
                p.grad = self._zero_grads[i]
        grads = [p.grad for p in self.params]
        if self.grad_accum > 1:
            self._accumulate(grads)
            grads = self.accumulators
        if self.updates_now:
            reduce_mean_(grads)
            if self.state_dtype == "bfloat16":
                for i, (p, g, buf) in enumerate(zip(self.params, grads, self.momentum_buffers)):
                    for run, offset, cols, stride in shard_runs(self.shards[i], (p, g, buf)):
                        sgd_bf16_update(*run, self.lr, self.count_tensor, self.momentum,
                                        self.weight_decay, self.seed, i, offset, cols, stride)
            else:
                self._step_f32(grads)
            if self.grad_accum > 1:
                torch._foreach_zero_(self.accumulators)
        self.advance()
        return lr

    def _accumulate(self, grads: list) -> None:
        """acc += (g - acc) / (micro + 1) for every parameter (optax's
        running mean, `_acc_update`), leaf by leaf through a temporary of
        one leaf: the gradients are left as they are."""
        for g, acc in zip(grads, self.accumulators):
            acc.add_(torch.sub(g, acc).div_(self.divisor))

    def _step_f32(self, grads: list) -> None:
        """g = grad + wd * p; buf = m * buf + g; p -= lr * buf, in one fused
        pass over all parameters (PyTorch's fused SGD, which reads the LR
        from its device tensor; the momentum buffers exist, so every update
        takes the m * buf + g branch, which from zero buffers gives g as the
        first step should)."""
        torch._fused_sgd_(self.params, grads, self.momentum_buffers,
                          weight_decay=self.weight_decay, momentum=self.momentum, lr=self.lr,
                          dampening=0.0, nesterov=False, maximize=False, is_first_step=False)

    def state_dict(self) -> dict:
        """The momentum buffers by parameter index (torch SGD's layout), the
        state dtype and the rounding seed; with `grad_accum` > 1 also the
        accumulators and the micro-step index. The count is the
        trainer's."""
        state = {"state": {i: {"momentum_buffer": b} for i, b in enumerate(self.momentum_buffers)},
                 "state_dtype": self.state_dtype, "seed": self.seed}
        if self.grad_accum > 1:
            state.update(grad_accum=self.grad_accum, micro=self.micro,
                         accumulators=list(self.accumulators))
        return state

    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s momentum buffers (and accumulators) into
        this optimizer's, in place (a captured CUDA graph keeps its
        pointers), and take its micro-step index. A buffer of another dtype
        or shape, another state dtype, or a window in progress of another
        `grad_accum`, raises; a state saved between windows loads under any
        `grad_accum`."""
        saved = state.get("state_dtype", "float32")
        if saved != self.state_dtype:
            raise ValueError(f"the state's state_dtype is {saved!r}, this optimizer's "
                             f"{self.state_dtype!r}")
        micro = int(state.get("micro", 0))
        if micro and state.get("grad_accum") != self.grad_accum:
            raise ValueError(f"the state is {micro} micro-steps into a window of "
                             f"{state.get('grad_accum')}; this optimizer accumulates "
                             f"{self.grad_accum}")
        bufs = state["state"]
        if len(bufs) != len(self.momentum_buffers):
            raise ValueError(f"the state holds {len(bufs)} momentum buffers, the optimizer "
                             f"{len(self.momentum_buffers)}")
        pairs = [(f"momentum buffer {i}", bufs[i]["momentum_buffer"], buf)
                 for i, buf in enumerate(self.momentum_buffers)]
        if self.grad_accum > 1:
            saved_acc = state.get("accumulators")
            pairs += [(f"accumulator {i}", saved_acc[i] if saved_acc else torch.zeros_like(acc), acc)
                      for i, acc in enumerate(self.accumulators)]
        for what, src, dst in pairs:
            if src.dtype != dst.dtype or src.shape != dst.shape:
                raise ValueError(f"{what}: {src.dtype} {tuple(src.shape)}, want "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
        self.micro = micro
        self.seed = state.get("seed", self.seed)
