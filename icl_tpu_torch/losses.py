"""Training losses of the ICL objective, channel-first (counterpart of
`icl_tpu/losses.py:26-165`, which is channel-last).

Logits and probabilities are [B, C, *spatial], labels [B, *spatial]
integers. Kept semantics of the reference:
  - `multiclass_dice_loss` uses the squared-sum denominator,
    `softmax_dice_loss` the linear one;
  - per-class dice sums are global over batch and space, and class means
    include the background class;
  - under data parallelism the sums and means run over the rows of every
    rank (`parallel.collectives`), so each rank computes the loss of the
    global batch, as the JAX package's step does;
  - smooth = 1e-5 on numerator and denominator;
  - the consistency target (`softmax_mse_loss`) and the pseudo-label
    prediction (`pseudo_soft_loss`) are detached.

The reference's other losses, which no step calls, follow at the end
(dice with either denominator, entropies, focal, EAM, KD and KL losses).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from icl_tpu_torch.models.layers import resize_linear
from icl_tpu_torch.parallel.collectives import global_mean, global_sum

SMOOTH = 1e-5


def _sum_but_channel(x: torch.Tensor) -> torch.Tensor:
    return global_sum(x, (0,) + tuple(range(2, x.ndim)))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy (torch CrossEntropyLoss()), the mean taken
    over the per-pixel terms: the card's mean-reducing kernel
    (nll_loss2d) adds with atomics, in another order each run."""
    return global_mean(F.cross_entropy(logits, labels.long(), reduction="none"))


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
        loss = loss + global_mean((torch.softmax(inp, dim=1) - tgt_sm) ** 2)
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


# ---- the reference's other losses (`icl_tpu/losses.py:37, 49, 168-260`),
# which no training step calls; channel-first, computed in f32 or f64 ----

def _log_entropy_terms(p: torch.Tensor) -> torch.Tensor:
    p = at_least_f32(p)
    return -(p * torch.log(p + 1e-6)).sum(1)


def dice_loss_squared(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice over global sums, squared-sum denominator (`dice_loss`)."""
    score = at_least_f32(score)
    target = target.to(score.dtype)
    intersect = (score * target).sum()
    return 1.0 - (2.0 * intersect + SMOOTH) / ((score * score).sum() + (target * target).sum()
                                                + SMOOTH)


def dice_loss_linear(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft dice over global sums, linear-sum denominator (`dice_loss1`)."""
    score = at_least_f32(score)
    target = target.to(score.dtype)
    intersect = (score * target).sum()
    return 1.0 - (2.0 * intersect + SMOOTH) / (score.sum() + target.sum() + SMOOTH)


def entropy_loss(p: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Mean over pixels of the class entropy of probabilities [B, C, ...],
    normalised by log(num_classes)."""
    return (_log_entropy_terms(p) / math.log(float(num_classes))).mean()


def entropy_minimization(p: torch.Tensor) -> torch.Tensor:
    """Mean over pixels of the unnormalised class entropy."""
    return _log_entropy_terms(p).mean()


def entropy_loss_map(p: torch.Tensor) -> torch.Tensor:
    """The per-pixel unnormalised class entropy [B, 1, ...]."""
    return _log_entropy_terms(p).unsqueeze(1)


def symmetric_mse_loss(input1: Sequence[torch.Tensor], input2: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-scale MSE of input2 against the detached FIRST scale of input1
    (the reference indexes input1[0] in every iteration), summed, / 3."""
    ref = at_least_f32(input1[0]).detach()
    loss = 0.0
    for x2 in input2:
        loss = loss + ((ref - at_least_f32(x2)) ** 2).mean()
    return loss / 3.0


def cos_sim_loss(input1: Sequence[torch.Tensor], input2: Sequence[torch.Tensor]) -> torch.Tensor:
    """len(input1) * (1 - cosine(input1[0], input2[0])) / 3 (the reference
    compares the first scales once per scale)."""
    a = at_least_f32(input1[0]).reshape(-1)
    b = at_least_f32(input2[0]).reshape(-1)
    cos = torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12)
    return len(input1) * (1.0 - cos) / 3.0


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: Sequence[float] | torch.Tensor | None = None) -> torch.Tensor:
    """FocalLoss, mean reduction: -(1 - pt)^gamma * alpha[label] * log pt,
    pt detached in the factor."""
    logp = torch.log_softmax(at_least_f32(logits), dim=1)
    logpt = logp.gather(1, labels.long().unsqueeze(1)).squeeze(1)
    pt = torch.exp(logpt.detach())
    if alpha is not None:
        logpt = logpt * torch.as_tensor(alpha, dtype=logpt.dtype, device=logpt.device)[labels.long()]
    return (-((1.0 - pt) ** gamma) * logpt).mean()


def eam_loss(feat_maps: Sequence[torch.Tensor], labels: torch.Tensor,
             spatial: Sequence[int] = (224, 224)) -> torch.Tensor:
    """EAMLoss: the CE of each class map upsampled to `spatial`, summed, / 3."""
    loss = 0.0
    for fm in feat_maps:
        loss = loss + cross_entropy_loss(resize_maps(fm, spatial), labels)
    return loss / 3.0


def kd_loss(guidance_1: Sequence[torch.Tensor], guidance_2: Sequence[torch.Tensor],
            temperature: float = 2.0) -> torch.Tensor:
    """KD_Loss: per scale, the symmetric KL between the temperature-softened
    distributions of the LAST class query [B, cls, C] -> [B, C] (the
    reference's loop keeps only the last class), mean over scales."""
    loss = 0.0
    for g1, g2 in zip(guidance_1, guidance_2):
        j = g1.shape[1] - 1
        p1 = torch.softmax(at_least_f32(g1[:, j, :]) / temperature, dim=1)
        p2 = torch.softmax(at_least_f32(g2[:, j, :]) / temperature, dim=1)
        loss = loss + ((p1 * torch.log(p1 / p2)).sum() + (p2 * torch.log(p2 / p1)).sum()) / 2.0
    return loss / float(len(guidance_1))


def compute_kl_loss(p: Sequence[torch.Tensor], q: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean over scales of the symmetric KL of class softmaxes, each
    direction's terms averaged over every element."""
    loss = 0.0
    for pn, qn in zip(p, q):
        lp, lq = torch.log_softmax(at_least_f32(pn), 1), torch.log_softmax(at_least_f32(qn), 1)
        p_loss = (lq.exp() * (lq - lp)).mean()
        q_loss = (lp.exp() * (lp - lq)).mean()
        loss = loss + (p_loss + q_loss) / 2.0
    return loss / len(q)


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(target) || softmax(input)) averaged over every element
    (F.kl_div(log_softmax(input), softmax(target), reduction="mean"))."""
    input_logp = torch.log_softmax(at_least_f32(input_logits), dim=1)
    target_sm = torch.softmax(at_least_f32(target_logits), dim=1)
    return (target_sm * (torch.log(target_sm.clamp_min(1e-38)) - input_logp)).mean()
