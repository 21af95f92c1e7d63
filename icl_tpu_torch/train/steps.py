"""The train steps (counterpart of `icl_tpu/train/steps.py`): the supervised
step, seg_weight * (CE + Dice) on a labeled batch (`make_supervised_step`,
:24-70), and the ICL semi-supervised step (`make_icl_step`, :73-141):

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

from icl_tpu_torch import losses
from icl_tpu_torch.train.optim import PolySGD

METRIC_KEYS = ("loss", "loss_seg", "loss_ce", "loss_dice", "loss_aux", "loss_pse",
               "loss_aux_consis")
SUPERVISED_METRIC_KEYS = ("loss", "loss_ce", "loss_dice")


def _check_precision(precision: str) -> None:
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision {precision!r}: want float32 or bfloat16")


def _forward_context(precision: str, device: torch.device):
    """autocast to bf16 for "bfloat16", nothing for "float32"."""
    if precision == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


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
        with _forward_context(precision, x.device):
            logits = model(x)
        logits = losses.at_least_f32(logits)
        loss_ce = losses.cross_entropy_loss(logits, y)
        loss_dice = losses.multiclass_dice_loss(logits, y, num_classes, softmax=True)
        loss = seg_weight * (loss_ce + loss_dice)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in zip(SUPERVISED_METRIC_KEYS, (loss, loss_ce, loss_dice))}

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
    device)."""
    patch = tuple(patch_size)
    _check_precision(precision)

    def step(batch: dict) -> dict:
        x, y = batch["image"], batch["label"]
        x_lab, x_unlab = x[:labeled_bs], x[labeled_bs:]
        y_lab = y[:labeled_bs]
        optimizer.zero_grad()
        with _forward_context(precision, x.device):
            outs = model(x_lab, x_unlab)
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
