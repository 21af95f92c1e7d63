"""The train steps (counterpart of `icl_tpu/train/steps.py`): the supervised
step, seg_weight * (CE + Dice) on a labeled batch (`make_supervised_step`,
:24-70), the FixMatch step of the CTAugment path (`make_fixmatch_cta_step`,
:144-242), and the ICL semi-supervised step (`make_icl_step`, :73-141):

    loss = (CE + Dice)             on the labeled main output
         + AuxLoss(fm_lab, gt)     ICL labeled maps against the labels
         + w_pse * PseudoSoftLoss  ICL unlabeled maps against the detached
                                   main unlabeled prediction
         + w_consis * softmax_mse  USCL against the detached SSPA maps
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from icl_tpu_torch import losses
from icl_tpu_torch.train.optim import PolySGD

METRIC_KEYS = ("loss", "loss_seg", "loss_ce", "loss_dice", "loss_aux", "loss_pse",
               "loss_aux_consis")
SUPERVISED_METRIC_KEYS = ("loss", "loss_ce", "loss_dice")
FIXMATCH_METRIC_KEYS = ("loss", "loss_ce", "loss_dice", "loss_unsup", "mask_ratio",
                        "probe_proximity")


def _check_precision(precision: str) -> None:
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision {precision!r}: want float32 or bfloat16")


def _forward_context(precision: str, device: torch.device):
    """autocast to bf16 for "bfloat16", nothing for "float32". autocast's
    cache of cast weights is off, in eager steps and under a CUDA graph
    capture alike. With the cache a weight that the step uses twice (the
    backbone's, by the labeled and the unlabeled pass) is cast once, and
    the two uses' bf16 gradients are summed in bf16 before the cast's
    backward takes them to f32; without it each use has its own cast and
    the sum is in f32, as in the JAX package, whose modules cast their f32
    parameters at each call. A capture cannot keep the cache (a cached cast
    would be made once, in the graph's memory), so with the cache on in
    eager steps a replay would sum otherwise than the eager step did."""
    if precision == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16, cache_enabled=False)
    return contextlib.nullcontext()


@contextlib.contextmanager
def upcast_parameters(model: torch.nn.Module, precision: str):
    """While in force, the model's bf16 parameters (the bf16 train state)
    are replaced by upcast f32 copies, as `torch.func.functional_call`
    replaces them for one call: all of them at precision "float32", as
    flax promotes bf16 weights to the f32 input's type; at "bfloat16" the
    normalisation layers' affine parameters only (BatchNorm,
    InstanceNorm), since their kernels take a bf16 input only with f32
    parameters beside the f32 running stats, and the other bf16 weights
    go into autocast as they are. The copies are differentiable, so the
    bf16 leaves receive bf16 gradients. A step holds this across its
    forward and its backward: a block recomputed in the backward
    (`models.layers.call_remat`) reads its parameters again, and must find
    the copies the first forward used, not the bf16 leaves. Nothing
    happens for a model whose parameters are not bf16; inside another
    such context the parameters are the copies already (`.float()` of an
    f32 tensor is the tensor itself)."""
    first = next(model.parameters(), None)
    if first is None or first.dtype != torch.bfloat16:
        yield
        return
    if precision == "float32":
        upcast = {n: p.float() for n, p in model.named_parameters()}
    else:
        upcast = {f"{mn}.{pn}": p.float() for mn, m in model.named_modules()
                  if isinstance(m, torch.nn.modules.batchnorm._NormBase)
                  for pn, p in m.named_parameters(recurse=False)}
    with torch.nn.utils.stateless._reparametrize_module(model, upcast):
        yield


def forward(model: torch.nn.Module, precision: str, *args):
    """model(*args) at `precision`, with the bf16 state's parameters upcast
    as `upcast_parameters` says for the length of the call."""
    with _forward_context(precision, args[0].device), upcast_parameters(model, precision):
        return model(*args)


def make_supervised_step(model: torch.nn.Module, optimizer: PolySGD, num_classes: int,
                         seg_weight: float = 1.0,
                         precision: str = "float32") -> Callable[[dict], dict]:
    """step(batch) -> metrics: seg_weight * (CE + Dice) on the whole batch
    ("image" [B, 1, *patch] f32, "label" [B, *patch] integers, all
    labeled), backward and one optimizer update. Precision as
    `make_icl_step`; metrics `SUPERVISED_METRIC_KEYS`, detached 0-d
    tensors."""
    _check_precision(precision)

    def step(batch: dict) -> dict:
        x, y = batch["image"], batch["label"]
        optimizer.zero_grad()
        with upcast_parameters(model, precision):  # forward and backward (a recompute) alike
            logits = losses.at_least_f32(forward(model, precision, x))
            loss_ce = losses.cross_entropy_loss(logits, y)
            loss_dice = losses.multiclass_dice_loss(logits, y, num_classes, softmax=True)
            loss = seg_weight * (loss_ce + loss_dice)
            loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in zip(SUPERVISED_METRIC_KEYS, (loss, loss_ce, loss_dice))}

    return step


def probe_proximity(model: torch.nn.Module, image: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The CTAugment probe's score, 1 - 0.5 * mean over pixels of the class
    SUM of |softmax(logits) - one_hot(label)| (the FixMatch weight, in
    [0, 1] whatever the number of classes): one forward in eval mode
    (running stats, no dropout) without gradients, the model left in
    train mode; a 0-d tensor. A label outside [0, classes) has an all-zero
    one-hot row, as in the JAX package: the probe's label map goes through
    the probe policy's intensity ops too (`cta_batches`), which can move
    it there."""
    model.eval()
    try:
        with torch.no_grad():
            probs = torch.softmax(model(image), dim=1)
    finally:
        model.train()
    onehot = losses.one_hot(label, probs.shape[1], probs.dtype)
    return 1.0 - 0.5 * (probs - onehot).abs().sum(1).mean()


def make_fixmatch_cta_step(model: torch.nn.Module, optimizer: PolySGD, num_classes: int,
                           labeled_bs: int, conf_thresh: float = 0.95,
                           unsup_weight: float = 1.0) -> Callable[[dict], dict]:
    """step(batch) -> metrics, FixMatch on CTAugment pairs: the weak
    forward of the whole batch (train mode, the first BatchNorm update),
    CE + Dice on its first `labeled_bs` samples; pseudo-labels, the argmax
    of the detached weak softmax of the other samples, kept where its
    maximum is >= conf_thresh; the strong forward of those samples (the
    second BatchNorm update, on the first's stats) and its per-pixel CE
    against the pseudo-labels, summed over the kept pixels and divided by
    max(their count, 1); loss = CE + Dice + unsup_weight * that; backward
    and one optimizer update; then the probe's proximity
    (`probe_proximity`) on the updated weights, in the same call. `batch`
    holds "image_weak", "image_strong" [B, 1, H, W], "label_aug" [B, H, W]
    integers, "probe_image" [1, 1, H, W] and "probe_label" [1, H, W]. A
    label outside [0, num_classes) (a LANCZOS or BICUBIC rescale of the
    label map can overshoot to one) is left out of the CE and has no class
    in the Dice target (`losses.one_hot`); the JAX step's CE turns NaN on
    it. Metrics `FIXMATCH_METRIC_KEYS`, detached 0-d tensors."""

    def step(batch: dict) -> dict:
        xw, xs, y = batch["image_weak"], batch["image_strong"], batch["label_aug"]
        optimizer.zero_grad()
        logits_w = model(xw)
        y_lab = y[:labeled_bs].long()
        ignore = (y_lab < 0) | (y_lab >= num_classes)
        loss_ce = F.cross_entropy(logits_w[:labeled_bs], y_lab.masked_fill(ignore, -100),
                                  ignore_index=-100)
        loss_dice = losses.multiclass_dice_loss(logits_w[:labeled_bs], y[:labeled_bs],
                                                num_classes, softmax=True)
        probs_u = torch.softmax(logits_w[labeled_bs:].detach(), dim=1)
        pseudo = probs_u.argmax(dim=1)
        mask = (probs_u.amax(dim=1) >= conf_thresh).to(logits_w.dtype)
        logits_s = model(xs[labeled_bs:])
        ce_pix = F.cross_entropy(logits_s, pseudo, reduction="none")
        loss_unsup = (ce_pix * mask).sum() / mask.sum().clamp_min(1.0)
        loss = loss_ce + loss_dice + unsup_weight * loss_unsup
        loss.backward()
        optimizer.step()
        metrics = {"loss": loss, "loss_ce": loss_ce, "loss_dice": loss_dice,
                   "loss_unsup": loss_unsup, "mask_ratio": mask.mean(),
                   "probe_proximity": probe_proximity(model, batch["probe_image"],
                                                      batch["probe_label"])}
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_icl_step(model: torch.nn.Module, optimizer: PolySGD, num_classes: int, labeled_bs: int,
                  patch_size: Sequence[int], consis_weight: float, pse_weight: float = 1.0,
                  precision: str = "float32") -> Callable[[dict], dict]:
    """step(batch) -> metrics: one forward of the two branches, the losses,
    backward and one optimizer update. `batch` holds "image" [B, 1,
    *patch] f32 and "label" [B, *patch] integers on the model's device,
    the first `labeled_bs` samples labeled. With precision "bfloat16" the
    forward runs under autocast; the losses take f32 maps (f64 ones stay
    f64). Metrics are detached 0-d tensors (reading them syncs the
    device). Under data parallelism (`parallel.mesh.data_group`) `batch` is
    this rank's rows (`parallel.multihost.host_rows`: its share of each
    branch, `labeled_bs` the labeled share), the losses and metrics are
    those of the global batch, and `PolySGD.step` reduces the gradients
    over the ranks at the update, so every rank makes the same update."""
    patch = tuple(patch_size)
    _check_precision(precision)

    def step(batch: dict) -> dict:
        x, y = batch["image"], batch["label"]
        x_lab, x_unlab = x[:labeled_bs], x[labeled_bs:]
        y_lab = y[:labeled_bs]
        optimizer.zero_grad()
        with upcast_parameters(model, precision):  # forward and backward (a recompute) alike
            outs = forward(model, precision, x_lab, x_unlab)
            out_lab, out_unlab, fm_lab, fm_unlab, fm_consis = (
                losses.at_least_f32(o) if torch.is_tensor(o) else [losses.at_least_f32(m) for m in o]
                for o in outs)
            loss_ce = losses.cross_entropy_loss(out_lab, y_lab)
            loss_dice = losses.multiclass_dice_loss(out_lab, y_lab, num_classes, softmax=True)
            loss_aux = losses.aux_loss(fm_lab, y_lab, num_classes, patch)
            loss_pse = losses.pseudo_soft_loss(fm_unlab, out_unlab, patch)
            loss_consis = losses.softmax_mse_loss(fm_unlab, fm_consis)
            loss_seg = loss_ce + loss_dice
            loss = loss_seg + loss_aux + pse_weight * loss_pse + consis_weight * loss_consis
            loss.backward()
        optimizer.step()
        values = (loss, loss_seg, loss_ce, loss_dice, loss_aux, loss_pse, consis_weight * loss_consis)
        return {k: v.detach() for k, v in zip(METRIC_KEYS, values)}

    return step
