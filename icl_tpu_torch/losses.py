"""Training losses of the ICL objective, channel-first (counterpart of
`icl_tpu/losses.py:26-165`, which is channel-last).

Logits and probabilities are [B, C, *spatial], labels [B, *spatial]
integers. Kept semantics of the reference:
  - `multiclass_dice_loss` uses the squared-sum denominator,
    `softmax_dice_loss` the linear one;
  - per-class dice sums are global over batch and space, and class means
    include the background class;
  - smooth = 1e-5 on numerator and denominator;
  - the consistency target (`softmax_mse_loss`) and the pseudo-label
    prediction (`pseudo_soft_loss`) are detached.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from icl_tpu_torch.models.layers import resize_linear

SMOOTH = 1e-5


def _sum_but_channel(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(0,) + tuple(range(2, x.ndim)))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy (torch CrossEntropyLoss()), the mean taken
    over the per-pixel terms: the card's mean-reducing kernel
    (nll_loss2d) adds with atomics, in another order each run."""
    return F.cross_entropy(logits, labels.long(), reduction="none").mean()


def one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, *spatial] integers -> [B, C, *spatial] 0/1 in `dtype`; a label
    outside [0, C) gives an all-zero row, as `jax.nn.one_hot` does. Only
    the FixMatch-CTA path meets such labels (its rescaled label maps can
    overshoot past the last class): the Dice of `make_fixmatch_cta_step`
    and `probe_proximity` in `train/steps.py` rely on the zero rows; on
    every other path the labels lie in [0, C)."""
    classes = torch.arange(num_classes, device=labels.device).view(1, -1, *[1] * (labels.ndim - 1))
    return (labels.long().unsqueeze(1) == classes).to(dtype)


def multiclass_dice_loss(inputs: torch.Tensor, labels: torch.Tensor, num_classes: int,
                         weight: Sequence[float] | None = None,
                         softmax: bool = False) -> torch.Tensor:
    """`DiceLoss.forward`: per-class squared-denominator dice over global
    sums, averaged over all classes, optional per-class weights."""
    if softmax:
        inputs = torch.softmax(inputs, dim=1)
    tgt = one_hot(labels, num_classes, inputs.dtype)
    intersect = _sum_but_channel(inputs * tgt)
    z = _sum_but_channel(inputs * inputs)
    y = _sum_but_channel(tgt * tgt)
    dice = 1.0 - (2.0 * intersect + SMOOTH) / (z + y + SMOOTH)
    if weight is not None:
        dice = dice * torch.as_tensor(weight, dtype=dice.dtype, device=dice.device)
    return dice.sum() / num_classes


def softmax_dice_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """Softmax both sides, per-class linear-denominator dice, mean over
    classes (the target is not detached here)."""
    input_sm = torch.softmax(input_logits, dim=1)
    target_sm = torch.softmax(target_logits, dim=1)
    intersect = _sum_but_channel(input_sm * target_sm)
    z = _sum_but_channel(input_sm)
    y = _sum_but_channel(target_sm)
    return (1.0 - (2.0 * intersect + SMOOTH) / (z + y + SMOOTH)).mean()


def softmax_mse_loss(input_logits: Sequence[torch.Tensor],
                     target_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scale MSE between softmaxed maps, targets detached, mean over
    scales (`loss_aux_consis`: USCL maps against SSPA maps, unlabeled)."""
    loss = 0.0
    for inp, tgt in zip(input_logits, target_logits):
        tgt_sm = torch.softmax(tgt.detach(), dim=1)
        loss = loss + ((torch.softmax(inp, dim=1) - tgt_sm) ** 2).mean()
    return loss / len(input_logits)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in f32, or as it is if it is f64."""
    return t if t.dtype == torch.float64 else t.float()


def resize_maps(feat_map: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    """Linear upsampling of class maps [B, C, *s] to `spatial` with
    half-pixel centres (F.interpolate's align_corners=False grid), in f32 or
    f64, as one matmul per axis (`layers.resize_linear`: a deterministic
    backward)."""
    return resize_linear(at_least_f32(feat_map), tuple(spatial), align_corners=False)


def aux_loss(feat_maps: Sequence[torch.Tensor], labels: torch.Tensor, num_classes: int,
             spatial: Sequence[int]) -> torch.Tensor:
    """`AuxLoss3D`: for each ICL scale, upsample the class map to the patch
    and take CE and softmax dice against the labels; each averaged over
    the scales, then summed."""
    loss_ce = 0.0
    loss_dice = 0.0
    for fm in feat_maps:
        fm_full = resize_maps(fm, spatial)
        loss_ce = loss_ce + cross_entropy_loss(fm_full, labels)
        loss_dice = loss_dice + multiclass_dice_loss(fm_full, labels, num_classes, softmax=True)
    n = len(feat_maps)
    return loss_ce / n + loss_dice / n


def pseudo_soft_loss(feat_maps: Sequence[torch.Tensor], predicts: torch.Tensor,
                     spatial: Sequence[int]) -> torch.Tensor:
    """`PseudoSoftLoss3D`: upsampled unlabeled ICL maps against the
    detached main unlabeled prediction (softmax dice), mean over scales."""
    de_predicts = predicts.detach()
    loss = 0.0
    for fm in feat_maps:
        loss = loss + softmax_dice_loss(resize_maps(fm, spatial), de_predicts)
    return loss / len(feat_maps)
