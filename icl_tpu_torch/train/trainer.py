"""Trainer: the train loop (counterpart of `icl_tpu/train/trainer.py:45-524`,
cut to what the port's training CLIs use): the ICL semi-supervised step
for the ICL models, the supervised step for the plain U-Nets, Swin-UNet
and SwinUNETR; metric logging every `log_interval` steps, validation
every `val_interval` steps, the best checkpoint (ICL heads stripped), the
full train state every `checkpoint_interval` steps and at the end of
`fit`, in the reference snapshot layout:

    {experiments_dir}/{exp}_{labeled_num}_labeled/{model}_exp_{num_tries}/
        log.txt
        log/scalars.jsonl   (and TensorBoard events where tensorboardX imports)
        model/model_best.pth
        model/state_step_{step:08d}.pt, model/state_last.pt

`restore_state` resumes from such a file: `fit` then continues from its
iteration.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import make_icl_step, make_supervised_step
from icl_tpu_torch.utils import checkpoint as ckpt
from icl_tpu_torch.utils.logging_utils import ScalarWriter, setup_logging

ICL_MODELS = ("swinunetr_icl", "icl_swinunet", "icl_unet", "unet_3D_icl")
SUPERVISED_MODELS = ("unet", "swinunet", "swinunetr", "unet_3D")
ACDC_CLASS_NAMES = ["RV", "Myo", "LV"]  # classes 1..3 (icl_tpu/train/trainer.py:29)


class Trainer:
    """Model, optimizer and step of one experiment, on `device` (the CUDA
    card unless the caller passes "cpu"): the ICL step for an ICL model,
    the supervised step (seg_weight * (CE + Dice)) for the others. Weights
    come from `generator` (default: a CPU generator seeded with cfg.seed).
    With precision "float32" on the card, TF32 is switched off for matmuls
    and cuDNN. `cfg.remat` recomputes the blocks of the 3D backbones
    (SwinUNETR's Swin blocks, the 3D U-Net's conv blocks) in the
    backward."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.model not in ICL_MODELS + SUPERVISED_MODELS:
            raise KeyError(f"model {cfg.model!r}: the port trains "
                           f"{list(ICL_MODELS + SUPERVISED_MODELS)} only")
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.precision == "float32" and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        # ICL models take the training patch (icl_tpu/train/trainer.py:58-63)
        model_kwargs = dict(cfg.model_kwargs)
        if cfg.fuse_icl_pair:
            model_kwargs["fuse_sspa_pair"] = True
        self.model = net_factory(cfg.model, cfg.in_chns, cfg.num_classes, device=self.device,
                                 generator=generator, feature_size=cfg.feature_size,
                                 patch_size=int(cfg.patch_size[0]), remat=cfg.remat,
                                 **model_kwargs)
        self.optimizer = PolySGD(self.model.parameters(), cfg.base_lr, cfg.max_iterations,
                                 cfg.momentum, cfg.weight_decay, cfg.poly_power)
        if cfg.model in ICL_MODELS:
            self.step_fn = make_icl_step(self.model, self.optimizer, cfg.num_classes,
                                         cfg.labeled_bs, cfg.patch_size, cfg.consis_weight,
                                         cfg.pse_weight, cfg.precision)
        else:
            self.step_fn = make_supervised_step(self.model, self.optimizer, cfg.num_classes,
                                                cfg.seg_weight, cfg.precision)
        self.iteration = 0

    def _generators(self) -> dict:
        """The model's own generators (a dropout's or drop path's), by the
        name of the first module that holds each."""
        out, seen = {}, set()
        for name, m in self.model.named_modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and id(g) not in seen:
                seen.add(id(g))
                out[name] = g
        return out

    def train_state(self) -> dict:
        """What a resume needs, as references to the live tensors: the
        model's state_dict (with its buffers: BatchNorm running stats and
        `num_batches_tracked`), the SGD state_dict (momentum buffers), the
        update count, the iteration, and the states of torch's CPU
        generator, of the card's default generator when the model is on
        the card, and of the model's own generators."""
        rng = {"cpu": torch.get_rng_state(),
               "modules": {n: g.get_state() for n, g in self._generators().items()}}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.optimizer.state_dict(),
                "count": self.optimizer.count, "iteration": self.iteration, "rng": rng}

    def load_train_state(self, state: dict) -> None:
        """Put `state` (`train_state`'s layout, tensors on any device) in
        place: model strictly, optimizer, count, iteration, generators."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.optimizer.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["count"])
        self.iteration = int(state["iteration"])
        rng = state["rng"]
        torch.set_rng_state(rng["cpu"].cpu())
        if "cuda" in rng:
            if self.device.type != "cuda":
                raise ValueError("the state holds the card's generator; restore it on the card")
            torch.cuda.set_rng_state(rng["cuda"].cpu(), self.device)
        generators = self._generators()
        if set(generators) != set(rng["modules"]):
            raise ValueError(f"the state's module generators {sorted(rng['modules'])} are not "
                             f"the model's {sorted(generators)}")
        for name, g in generators.items():
            g.set_state(rng["modules"][name].cpu())

    def restore_state(self, name: str = "last") -> int:
        """Resume from `<snapshot>/model/state_{name}.pt` (counterpart of
        `restore_state`, icl_tpu/train/trainer.py:198-218), mapped to the
        trainer's device; `fit` then continues from its iteration, which
        is returned."""
        self.load_train_state(ckpt.load_train_state(self.cfg.snapshot_path, name, self.device))
        return self.iteration

    def _save_state(self, logger, saves: list, step: Optional[int] = None) -> None:
        """The rolling step file (`step` given) or `state_last`, timed."""
        snapshot = self.cfg.snapshot_path
        state = self.train_state()
        nbytes = ckpt.state_bytes(state)
        t0 = time.perf_counter()
        if step is None:
            path = ckpt.save_train_state(snapshot, state, "last")
        else:
            path = ckpt.save_train_state_rolling(snapshot, state, step, self.cfg.keep_checkpoints)
        seconds = time.perf_counter() - t0
        saves.append({"iteration": self.iteration, "path": path, "bytes": nbytes,
                      "seconds": seconds})
        logger.info("%s full-state save at iter %d: %.2f GB in %.2f s (%.2f GB/s) -> %s",
                    "final" if step is None else "periodic", self.iteration, nbytes / 1e9,
                    seconds, nbytes / 1e9 / max(seconds, 1e-9), path)

    def to_device(self, batch: dict) -> dict:
        """The batch's image (f32) and labels (long) on the device: numpy
        arrays or CPU tensors, copied asynchronously where pinned (a
        `Prefetcher` with `pin_memory`), or tensors already there."""
        return {"image": torch.as_tensor(batch["image"], dtype=torch.float32)
                .to(self.device, non_blocking=True),
                "label": torch.as_tensor(batch["label"]).to(self.device, non_blocking=True).long()}

    def fit(self, train_batches: Iterable[dict],
            evaluate: Optional[Callable[[torch.nn.Module], dict]] = None,
            class_names: Optional[list[str]] = None) -> dict:
        """Run up to cfg.max_iterations steps. `evaluate(model)` runs every
        cfg.val_interval steps, with the model in eval mode, and returns
        the aggregate of `metrics.aggregate_case_metrics`; a new best
        mean dice saves the best checkpoint. Each logged step writes the
        scalars `Info/lr` and `Loss/<metric>`, each validation
        `metric_all/{mean,std}_{dice,hd95}` and
        `metric_class_<name>/mean_{dice,hd95}` (`ScalarWriter` under
        `<snapshot>/log`). After that step's validation, every
        cfg.checkpoint_interval steps write the rolling train state; the
        run ends with `state_last.pt`, as the JAX `fit` does. It starts
        from `self.iteration` (0, or where `restore_state` left it) and
        the best dice from 0. Returns {"log": one dict per logged step
        (iteration, seconds since the start, lr, metrics), "vals": one dict
        per validation (iteration, mean_dice, mean_hd95, its seconds),
        "best_mean_dice", "best_path", "saves": one dict per train-state
        save (iteration, path, bytes, seconds)}."""
        cfg = self.cfg
        snapshot = cfg.snapshot_path
        logger = setup_logging(snapshot)
        writer = ScalarWriter(f"{snapshot}/log")
        try:
            return self._fit(train_batches, evaluate, class_names, logger, writer)
        finally:
            writer.close()

    def _fit(self, train_batches, evaluate, class_names, logger, writer) -> dict:
        cfg = self.cfg
        snapshot = cfg.snapshot_path
        if class_names is None:
            class_names = (ACDC_CLASS_NAMES if cfg.num_classes == 4
                           else [str(i) for i in range(1, cfg.num_classes)])
        log, vals, saves = [], [], []
        best, best_path = 0.0, None
        batch_iter = iter(train_batches)
        if self.iteration:
            logger.info("resuming from iteration %d", self.iteration)
        self.model.train()
        t_start = time.perf_counter()
        while self.iteration < cfg.max_iterations:
            try:
                batch = self.to_device(next(batch_iter))
            except StopIteration:
                break
            metrics = self.step_fn(batch)
            self.iteration += 1
            it = self.iteration
            if it % cfg.log_interval == 0:
                host = {k: float(v) for k, v in metrics.items()}  # syncs the card
                lr = self.optimizer.schedule(it - 1)
                log.append({"iteration": it, "seconds": time.perf_counter() - t_start, "lr": lr,
                            **host})
                writer.add_scalar("Info/lr", lr, it)
                for k, v in host.items():
                    writer.add_scalar(f"Loss/{k}", v, it)
                logger.info("iteration %d : " + ", ".join(f"{k}: {v:f}" for k, v in host.items()), it)
            if evaluate is not None and cfg.val_interval and it % cfg.val_interval == 0:
                self.model.eval()
                t_val = time.perf_counter()
                agg = evaluate(self.model)
                val_s = time.perf_counter() - t_val
                self.model.train()
                vals.append({"iteration": it, "mean_dice": agg["mean_dice"],
                             "mean_hd95": agg["mean_hd95"], "seconds": val_s})
                for k in ("mean_dice", "mean_hd95", "std_dice", "std_hd95"):
                    writer.add_scalar(f"metric_all/{k}", agg[k], it)
                for name, (dice, hd95) in zip(class_names, agg["class_mean"]):
                    writer.add_scalar(f"metric_class_{name}/mean_dice", dice, it)
                    writer.add_scalar(f"metric_class_{name}/mean_hd95", hd95, it)
                    logger.info("iteration %d : class %s : dice %f  hd95 %f", it, name, dice, hd95)
                logger.info("iteration %d : mean_dice : %f  mean_hd95 : %f  (%.2f s)",
                            it, agg["mean_dice"], agg["mean_hd95"], val_s)
                if agg["mean_dice"] > best:
                    best = agg["mean_dice"]
                    best_path = ckpt.save_best_model(snapshot, self.model)
                    logger.info("saving best model at iter %d -> %s", it, best_path)
            if cfg.checkpoint_interval and it % cfg.checkpoint_interval == 0:
                self._save_state(logger, saves, step=it)
        elapsed = time.perf_counter() - t_start
        logger.info("Training finished: %d iters in %.1fs (%.2f it/s)",
                    self.iteration, elapsed, self.iteration / max(elapsed, 1e-9))
        self._save_state(logger, saves)
        return {"log": log, "vals": vals, "best_mean_dice": best, "best_path": best_path,
                "saves": saves}


def brats_evaluator(dataset, num_classes: int, patch_size, device) -> Callable[[torch.nn.Module], dict]:
    """evaluate(model) for `fit`: the BraTS sliding window (stride 64,
    sw_batch 4) over `dataset`, aggregated per class."""
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics

    def evaluate(model: torch.nn.Module) -> dict:
        metric_cal = evaluate_brats_cases(make_patch_predictor(model), dataset, num_classes,
                                          tuple(patch_size), 64, 64, sw_batch=4, device=device)
        return aggregate_case_metrics(metric_cal)

    return evaluate


def amos_evaluator(dataset, num_classes: int, patch_size, device) -> Callable[[torch.nn.Module], dict]:
    """evaluate(model) for `fit`: the AMOS protocol (`evaluate_amos_cases`:
    stride 0.75 of the patch, sw_batch 4, input rounded to bf16, logits
    stitched) over `dataset`, aggregated per organ."""
    from icl_tpu_torch.eval.infer3d import evaluate_amos_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics

    def evaluate(model: torch.nn.Module) -> dict:
        scores = make_patch_predictor(model, apply_softmax=False, dtype=torch.bfloat16)
        return aggregate_case_metrics(evaluate_amos_cases(scores, dataset, num_classes,
                                                          tuple(patch_size), device=device))

    return evaluate


def acdc_evaluator(dataset, num_classes: int, patch_size, device) -> Callable[[torch.nn.Module], dict]:
    """evaluate(model) for `fit`: the 2D slice predictor over the volumes
    of `dataset`, aggregated per class."""
    from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor

    def evaluate(model: torch.nn.Module) -> dict:
        return evaluate_acdc_volumes(make_slice_predictor(model, patch_size, device), dataset,
                                     num_classes)

    return evaluate
