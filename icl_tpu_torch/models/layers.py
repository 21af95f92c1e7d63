"""Shared layers (counterpart of `icl_tpu/models/layers.py` and the norms
of `models/unet3d.py` and `models/swin2d.py`), with torch's default
initialisation drawn from an explicit generator."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from icl_tpu_torch.parallel.collectives import all_reduce_sum, world_size
from icl_tpu_torch.parallel.mesh import data_group

EPS = 1e-5


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch nn.GELU default (exact erf form)."""
    return F.gelu(x)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine or running stats, eps 1e-5, over the
    spatial dims of an N C ... tensor (`InstanceNorm`, unet3d.py:29-38).
    Written out because F.instance_norm refuses a 1-voxel map, which
    encoder10 sees at a 32^3 patch; there it gives 0, as the JAX one."""
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.ndim)), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def layer_norm_no_affine(x: torch.Tensor) -> torch.Tensor:
    """Parameterless LayerNorm over the last axis (swinunetr.py:393)."""
    return F.layer_norm(x, x.shape[-1:], eps=EPS)


def layer_norm(dim: int) -> nn.LayerNorm:
    """LayerNorm with eps 1e-5 (`SwinLayerNorm`, swin2d.py:59-62)."""
    return nn.LayerNorm(dim, eps=EPS)


def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default init for a conv or linear layer:
    kaiming_uniform(a=sqrt(5)) weight, U(+-1/sqrt(fan_in)) bias."""
    nn.init.kaiming_uniform_(module.weight, a=math.sqrt(5), generator=generator)
    if module.bias is not None:
        fan_in, _ = nn.init._calculate_fan_in_and_fan_out(module.weight)
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(module.bias, -bound, bound, generator=generator)


def swin_linear_init_(module: nn.Linear, generator: torch.Generator) -> None:
    """Swin linears: trunc_normal(0.02) weight, zero bias (`SwinDense`)."""
    nn.init.trunc_normal_(module.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
    if module.bias is not None:
        nn.init.zeros_(module.bias)


class _GlobalBatchNorm:
    """A BatchNorm whose training-mode statistics are those of the global
    batch when a data-parallel group of more than one process is active
    (`parallel.mesh.data_group`), as the JAX package's BatchNorm takes them
    over the batch axis that XLA shards; else torch's own BatchNorm, as it
    is. The global statistics: two-pass f32 sums (f64 for f64) over every
    rank's rows through the differentiable all-reduce, the global count n,
    the biased variance in the normalisation, the unbiased one (n / (n - 1))
    in running_var, as torch's SyncBatchNorm; the output in the input's
    dtype. Same parameters, buffers and state-dict keys as torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or data_group() is None:
            return super().forward(x)
        return self._global_forward(x)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x if x.dtype == torch.float64 else x.float()
        n = x.numel() // x.shape[1] * world_size()
        mean = all_reduce_sum(xf.sum(dims)) / n
        xc = xf - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims)) / n
        y = xc * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.to(y.dtype).view(shape) + self.bias.to(y.dtype).view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                unbiased = var * (n / (n - 1))
                self.running_var.mul_(1.0 - m).add_(unbiased.to(self.running_var.dtype), alpha=m)
        return y.to(x.dtype)


class BatchNorm2d(_GlobalBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_GlobalBatchNorm, nn.BatchNorm3d):
    pass


def batch_norm(num_features: int, spatial_dims: int) -> nn.Module:
    """BatchNorm with torch's defaults, eps 1e-5 and momentum 0.1
    (`BatchNorm`, layers.py:110-118), over the global batch under data
    parallelism (`_GlobalBatchNorm`). Its running_var takes the unbiased
    batch variance; the JAX package's takes the biased one."""
    cls = {2: BatchNorm2d, 3: BatchNorm3d}[spatial_dims]
    return cls(num_features, eps=EPS, momentum=0.1)


@functools.lru_cache(maxsize=64)
def _linear_matrix(n_in: int, n_out: int, align_corners: bool, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """[n_out, n_in] weights of linear interpolation along one axis, on the
    align_corners=True grid or with half-pixel centres (F.interpolate's
    source index, clamped at 0), made once per geometry: at a model's first
    step, before any CUDA graph capture, which cannot copy from the host."""
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = out * ((n_in - 1) / (n_out - 1)) if n_out > 1 else np.zeros(n_out)
    else:
        src = np.maximum((out + 0.5) * (n_in / n_out) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w = src - i0
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), i0), 1.0 - w)
    np.add.at(m, (np.arange(n_out), i1), w)
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def resize_linear(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    """Linear resizing of the last len(size) axes of x to `size`, one
    matmul per axis in f32 (f64 for f64), autocast off, the result in x's
    dtype: the values of F.interpolate's (bi/tri)linear modes up to f32
    rounding. As matmuls the backward is deterministic; F.interpolate's
    backward on the card adds with atomics, in another order each run."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.autocast(x.device.type, enabled=False):
        y = x.to(ct)
        for k, n_out in enumerate(size):
            dim = x.ndim - len(size) + k
            m = _linear_matrix(y.shape[dim], int(n_out), align_corners, ct, x.device)
            y = torch.movedim(torch.matmul(m, torch.movedim(y, dim, -2)), -2, dim)
    return y.to(x.dtype)


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear (2D) or trilinear (3D) upsampling by `factor` on the
    align_corners=True grid of a channel-first x, the upsampling of the
    reference's 2D decoders (`upsample_align_corners`, layers.py:169-182,
    which computes it as one small matmul per axis, as this does)."""
    return resize_linear(x, [n * factor for n in x.shape[2:]], align_corners=True)


def call_remat(remat: bool, fn, *args):
    """fn(*args), recomputed in the backward when `remat` is set and
    autograd records (non-reentrant checkpoint). Under a CUDA graph capture
    the recompute runs inside the captured backward and is recorded with
    it, so a replay recomputes as the eager step does, given that: `fn`
    draws no random numbers (the 3D U-Net's dropouts sit between its
    recomputed blocks, so no saved RNG state is replayed); `fn` reads no
    host value; and the
    recompute's autocast casts its weights again, as the first forward did,
    with autocast's weight cache off in eager steps too
    (`train/steps.py:_forward_context`), where a cached cast would make
    eager and replayed steps sum a shared weight's gradients in another
    precision. With the bf16 train state `fn` reads the upcast copies of
    the parameters in the recompute as in the first forward: the step
    keeps them in place until its backward is done
    (`train/steps.py:upcast_parameters`), in a capture too."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Dropout(nn.Module):
    """Element-wise dropout (flax `nn.Dropout`, as the U-Net's ConvBlock
    uses it): in training, keep each element with probability 1 - p and
    scale it by 1 / (1 - p); the identity in eval or at p 0. The keep mask
    comes from `generator` (on the tensor's device) or else torch's
    default RNG."""

    def __init__(self, p: float, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p == 0.0 or not self.training:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth (`DropPath`, layers.py:129-147): in training, keep
    each sample's whole branch with probability 1 - rate and scale it by
    1 / (1 - rate); the identity in eval or at rate 0. The keep mask comes
    from `generator` (on the tensor's device) or else torch's default RNG."""

    def __init__(self, rate: float, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """The reference init, drawn from `generator`: trunc_normal(0.02) Swin
    linears and relative-position bias tables, unit LayerNorms and
    BatchNorms with fresh running stats, torch-default convs. A submodule
    with its own `init_weights_` (an ICL head, the 3D U-Net's kaiming
    convs) is skipped here and initialised by that method afterwards, in
    module order. Buffers that
    a module makes from its geometry are remade by its `reset_buffers_`
    (`build_model` builds on the meta device)."""
    heads = [m for m in model.modules() if m is not model and hasattr(m, "init_weights_")]
    in_heads = {id(sub) for head in heads for sub in head.modules()}
    for m in model.modules():
        if id(m) in in_heads:
            continue
        if hasattr(m, "relative_position_bias_table"):
            nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        elif isinstance(m, nn.Linear):
            swin_linear_init_(m, generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d, nn.BatchNorm3d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.reset_running_stats()
        elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            torch_default_init_(m, generator)
        if hasattr(m, "reset_buffers_"):
            m.reset_buffers_()
    for head in heads:
        head.init_weights_(generator)


def build_model(cls: type, *args, device: torch.device, generator: torch.Generator,
                **kwargs) -> nn.Module:
    """`cls(*args, **kwargs)` with the reference init from a CPU
    `generator` (so the same seed gives the same weights on every device),
    moved to `device`, in torch's default train mode."""
    with torch.device("meta"):
        model = cls(*args, **kwargs)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        init_weights_(model, generator)
    return model.to(device)
