"""CTAugment-active training: the FixMatch step with the CTA control loop
(counterpart of `icl_tpu/train/cta.py`).

`CTATrainer.fit` trains on `cta_batches`, whose policies come from a live
`CTAugment`, and after every step moves the op rates by the probe's
proximity (rate = decay * rate + (1 - decay) * proximity at the drawn
bin). The probe forward runs in the step's call, on the updated weights
(`make_fixmatch_cta_step`).

The path trains the plain U-Net (`unet`), the JAX CLI's default, and the
Swin-UNet (`swinunet`, the JAX CLI's `--model swinunet`, at 224^2 with
window 7: its window attention runs the CUDA kernels, forward and
backward, at two batch sizes, the weak forward of the whole batch and the
strong forward of its unlabeled part). Every other model is refused
before anything is built: the JAX step fails at its first call on the
models whose forward returns a tuple (the ICL models, `unet_cct`,
`unet_urpc`, `unet_ds`). The JAX
`fit` counts its steps from 0 on every call, so a resumed run trains
`max_iterations` more steps and names its rolling saves from the first
interval again, and it ends with no train state saved; here `fit`
continues from the restored iteration up to `max_iterations`, names each
rolling save by its step and ends with `state_last`, as `Trainer` does.
"""
from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.ctaugment import CTAugment
from icl_tpu_torch.train.steps import make_fixmatch_cta_step, probe_proximity
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils.logging_utils import setup_logging


CTA_MODELS = ("unet", "swinunet")


class CTATrainer(Trainer):
    """The U-Net or the Swin-UNet, `PolySGD` and the fused-probe FixMatch
    step on `device` (the CUDA card unless the caller passes "cpu"), f32
    with TF32 off on the card; the train state, `restore_state` and the
    rolling saves are `Trainer`'s."""

    def __init__(self, cfg: ExperimentConfig, conf_thresh: float = 0.95,
                 unsup_weight: float = 1.0, device=None):
        if cfg.model not in CTA_MODELS:
            raise ValueError(
                f"model {cfg.model!r}: the FixMatch-CTA path trains {list(CTA_MODELS)}, whose "
                "forward returns one logits tensor; the ICL models and the U-Net variants return "
                "tuples (the JAX step fails on them at its first call)")
        if len(cfg.patch_size) != 2:
            raise ValueError(f"the CTA path is 2D (ACDC); patch {tuple(cfg.patch_size)}")
        fast = {k: getattr(cfg, k) for k in ("state_dtype", "device_augment", "scan_steps",
                                              "dispatch_depth", "grad_accum")}
        if fast != {"state_dtype": "float32", "device_augment": False, "scan_steps": 1,
                    "dispatch_depth": 1, "grad_accum": 1}:
            raise ValueError(f"{fast}: the FixMatch-CTA path (its JAX CLI too) has none of the "
                             "flagship's fast options and no gradient accumulation")
        super().__init__(cfg, device=device)
        self.step_fn = make_fixmatch_cta_step(self.model, self.optimizer, cfg.num_classes,
                                              cfg.labeled_bs, conf_thresh, unsup_weight)

    def probe_proximity(self, probe_image, probe_label) -> float:
        """The proximity of one probe ([1, 1, H, W], [1, H, W]) under the
        current weights, by a forward of its own."""
        return float(probe_proximity(
            self.model, torch.as_tensor(probe_image, dtype=torch.float32).to(self.device),
            torch.as_tensor(probe_label).to(self.device)))

    def to_device(self, batch: dict) -> dict:
        """A `cta_batches` batch's arrays on the device (images f32, labels
        long); the host-only policy left out."""
        out = {k: torch.as_tensor(batch[k], dtype=torch.float32).to(self.device, non_blocking=True)
               for k in ("image_weak", "image_strong", "probe_image")}
        for k in ("label_aug", "probe_label"):
            out[k] = torch.as_tensor(batch[k]).to(self.device, non_blocking=True).long()
        return out

    def fit(self, batches: Iterable[dict], cta: CTAugment, max_steps: Optional[int] = None,
            snapshot_path: Optional[str] = None, rate_lag: int = 1) -> dict:
        """The CTA control loop from `self.iteration` up to `max_steps`
        (default cfg.max_iterations). Each iteration takes a batch, runs the
        step, then applies the previous step's rate update, whose
        proximity the card has computed by then, and keeps its own for the
        next iteration (`rate_lag=1`, the JAX order); `rate_lag=0` applies
        each step's update at once. The metrics are read on the host with
        the rate update, which waits for their step. With `snapshot_path`,
        every cfg.checkpoint_interval's last step flushes the pending
        update, then saves the rolling train state and
        `<snapshot>/model/cta_state.json`, and the run ends with
        `state_last` and the rates. Returns {"log": one dict per step
        (iteration, "started": seconds since the start when the iteration
        took its batch, "seconds": when its metrics were read, lr,
        metrics), "saves": one dict per train-state save}."""
        cfg = self.cfg
        if rate_lag not in (0, 1):
            raise ValueError(f"rate_lag {rate_lag}: want 0 or 1")
        if snapshot_path not in (None, cfg.snapshot_path):
            raise ValueError(f"snapshot_path {snapshot_path!r}: the train state is saved under "
                             f"cfg.snapshot_path {cfg.snapshot_path!r}")
        steps = max_steps or cfg.max_iterations
        interval = cfg.checkpoint_interval if snapshot_path else 0
        logger = setup_logging(snapshot_path) if snapshot_path else None
        log, saves = [], []
        pending = None  # (iteration, its start, probe policy, metrics on the device)
        t_start = time.perf_counter()

        def settle(it, started, policy, metrics):
            host = {k: float(v) for k, v in metrics.items()}  # waits for that step
            cta.update_rates(policy, host["probe_proximity"])
            log.append({"iteration": it, "started": started,
                        "seconds": time.perf_counter() - t_start,
                        "lr": self.optimizer.schedule(it - 1), **host})
            if logger is not None:
                logger.info("iteration %d : " + ", ".join(f"{k}: {v:f}" for k, v in host.items()), it)

        batch_iter = iter(batches)
        self.model.train()
        while self.iteration < steps:
            started = time.perf_counter() - t_start
            try:
                batch = next(batch_iter)
            except StopIteration:
                break
            metrics = self.step_fn(self.to_device(batch))
            self.iteration += 1
            it = self.iteration
            if pending is not None:
                settle(*pending)
                pending = None
            if rate_lag == 0:
                settle(it, started, batch["probe_policy"], metrics)
            else:
                pending = (it, started, batch["probe_policy"], metrics)
            if interval and it % interval == 0:
                if pending is not None:
                    settle(*pending)
                    pending = None
                self._save_state(logger, saves, step=it)
                cta.save(os.path.join(snapshot_path, "model", "cta_state.json"))
        if pending is not None:
            settle(*pending)
        if snapshot_path:
            self._save_state(logger, saves)
            cta.save(os.path.join(snapshot_path, "model", "cta_state.json"))
        return {"log": log, "saves": saves}

    @staticmethod
    def restore_cta(snapshot_path: str, cta: CTAugment) -> bool:
        """The persisted rates of `<snapshot>/model/cta_state.json` into
        `cta`, if there are any; whether there were."""
        path = os.path.join(snapshot_path, "model", "cta_state.json")
        if os.path.exists(path):
            cta.restore(path)
            return True
        return False
