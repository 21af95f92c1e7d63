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

The JAX trainer's fast configuration is here too: a bf16 train state
(`cfg.state_dtype`), the augmentations on the device inside the step
(`cfg.device_augment`: raw slices or a device-resident bank), groups of
`cfg.scan_steps` steps that never cross a validation, checkpoint or end
boundary, on the card replays of one captured CUDA graph of the whole step
(the counterpart of `lax.scan` over K steps, `icl_tpu/train/trainer.py:
139-163, 326-375`), and up to `cfg.dispatch_depth` groups in flight, their
metrics copied to pinned host memory and read only when the group leaves
that window (:289-400).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.device_augment import AUGMENT_KEYS, augment_batch
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import forward, make_icl_step, make_supervised_step
from icl_tpu_torch.utils import checkpoint as ckpt
from icl_tpu_torch.utils.logging_utils import ScalarWriter, setup_logging

ICL_MODELS = ("swinunetr_icl", "icl_swinunet", "icl_unet", "unet_3D_icl")
SUPERVISED_MODELS = ("unet", "swinunet", "swinunetr", "unet_3D")
ACDC_CLASS_NAMES = ["RV", "Myo", "LV"]  # classes 1..3 (icl_tpu/train/trainer.py:29)
BANK_KEYS = ("image_bank", "label_bank")  # the same tensors every step


class _Promoted(torch.nn.Module):
    """A bf16-state model as its validation sees it: the forward in f32 on
    upcast copies of the bf16 parameters (`steps.forward`), as flax
    promotes bf16 weights to the f32 input's type in the JAX package's
    validation."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args):
        return forward(self.model, "float32", *args)


def launch_counts() -> dict:
    """The kernels' launch counters ({wrapper: launches}). Inside a CUDA
    graph capture a wrapper counts the launch it records; replays run no
    wrapper and count nothing."""
    from icl_tpu_torch.ops import sgd_bf16, window_attention as wa

    return {"window_attention": wa.window_attention.launches,
            "window_attention_bwd": wa.window_attention_bwd.launches,
            "sgd_bf16": sgd_bf16.sgd_bf16_update.launches}


class Trainer:
    """Model, optimizer and step of one experiment, on `device` (the CUDA
    card unless the caller passes "cpu"): the ICL step for an ICL model,
    the supervised step (seg_weight * (CE + Dice)) for the others. Weights
    come from `generator` (default: a CPU generator seeded with cfg.seed).
    With precision "float32" on the card, TF32 is switched off for matmuls
    and cuDNN. `cfg.remat` recomputes the blocks of the 3D backbones
    (SwinUNETR's Swin blocks, the 3D U-Net's conv blocks) in the
    backward. With `cfg.state_dtype` "bfloat16" the parameters are stored
    in bf16 (BatchNorm running stats and counters stay as they are, as the
    JAX package keeps `batch_stats` f32) and updated by the fused
    stochastic-rounding kernel; the forward follows `steps.forward`. With
    `cfg.device_augment` the step takes raw slices or a bank with indices,
    and the augment draws (`to_device`)."""

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
        if cfg.state_dtype == "bfloat16" and cfg.remat:
            # the f32 forward of a bf16 state runs on upcast copies handed to
            # functional_call; a recompute in the backward would run outside
            # that call, on the module's own bf16 tensors
            raise ValueError("state_dtype 'bfloat16' with remat is not ported")
        if cfg.device_augment and len(cfg.patch_size) != 2:
            raise ValueError("device_augment is 2D-only")
        self.model = net_factory(cfg.model, cfg.in_chns, cfg.num_classes, device=self.device,
                                 generator=generator, feature_size=cfg.feature_size,
                                 patch_size=int(cfg.patch_size[0]), remat=cfg.remat,
                                 **model_kwargs)
        if cfg.state_dtype == "bfloat16":
            for p in self.model.parameters():
                p.data = p.data.to(torch.bfloat16)
        self.optimizer = PolySGD(self.model.parameters(), cfg.base_lr, cfg.max_iterations,
                                 cfg.momentum, cfg.weight_decay, cfg.poly_power,
                                 state_dtype=cfg.state_dtype)
        if cfg.model in ICL_MODELS:
            self.step_fn = make_icl_step(self.model, self.optimizer, cfg.num_classes,
                                         cfg.labeled_bs, cfg.patch_size, cfg.consis_weight,
                                         cfg.pse_weight, cfg.precision)
        else:
            self.step_fn = make_supervised_step(self.model, self.optimizer, cfg.num_classes,
                                                cfg.seg_weight, cfg.precision)
        if cfg.device_augment:
            self.step_fn = self._augmenting(self.step_fn)
        self.iteration = 0
        self.metric_keys: tuple = ()
        self._graph: Optional[dict] = None
        # kernel launches recorded in the captured step, replayed with it
        self.graph_launches: dict = {}
        self.replays = 0

    def _augmenting(self, inner: Callable[[dict], dict]) -> Callable[[dict], dict]:
        """The device-augment step (icl_tpu/train/trainer.py:92-117): from
        raw slices {"image" [B, S, S] or [B, 1, S, S], "label"} or from a
        bank {"image_bank" [N, S, S], "label_bank", "indices" [B]}, and the
        draws "augment", it gathers, augments to the patch and runs `inner`
        in one call."""
        patch = int(self.cfg.patch_size[0])

        def step(batch: dict) -> dict:
            if "indices" in batch:
                img = batch["image_bank"].index_select(0, batch["indices"]).float()
                lab = batch["label_bank"].index_select(0, batch["indices"])
            else:
                img, lab = batch["image"], batch["label"]
                if img.ndim == 4:
                    img = img[:, 0]
            img, lab = augment_batch(img, lab, dict(zip(AUGMENT_KEYS, batch["augment"])), patch)
            return inner({"image": img, "label": lab.long()})

        return step

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
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "count": self.optimizer.count, "iteration": self.iteration, "rng": rng,
                "state_dtype": self.cfg.state_dtype}

    def load_train_state(self, state: dict) -> None:
        """Put `state` (`train_state`'s layout, tensors on any device) in
        place: model strictly, optimizer, count, iteration, generators. The
        tensors are copied into the live ones, so a captured CUDA graph of
        the step stays valid. A state of another `state_dtype` raises."""
        saved = state.get("state_dtype", "float32")
        if saved != self.cfg.state_dtype:
            raise ValueError(f"the train state's state_dtype is {saved!r}, the trainer's "
                             f"{self.cfg.state_dtype!r}")
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
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
        """The batch on the device: numpy arrays or CPU tensors copied
        asynchronously where pinned (a `Prefetcher` with `pin_memory`), or
        tensors already there. "image" f32 and "label" long; a bank batch's
        banks as they are (they must lie on the device) and its "indices"
        long; the device-augment draws ("augment": a dict of arrays [B])
        as one long tensor [4, B], rows in AUGMENT_KEYS order."""
        def put(v, dtype=None):
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            return t.to(dtype) if dtype is not None else t.long()

        if "indices" in batch:
            for k in BANK_KEYS:
                if batch[k].device.type != self.device.type:
                    raise ValueError(f"{k} lies on {batch[k].device}, the trainer on {self.device}")
            out = {k: batch[k] for k in BANK_KEYS}
            out["indices"] = put(batch["indices"])
        else:
            out = {"image": put(batch["image"], torch.float32), "label": put(batch["label"])}
        if "augment" in batch:
            out["augment"] = put(np.stack([np.asarray(batch["augment"][k]) for k in AUGMENT_KEYS]))
        return out

    def _stacked_step(self, batch: dict) -> torch.Tensor:
        """`step_fn(batch)`'s metrics as one vector, in `metric_keys` order."""
        metrics = self.step_fn(batch)
        self.metric_keys = tuple(metrics)
        return torch.stack([metrics[k] for k in self.metric_keys])

    def train_step(self, batch: dict) -> torch.Tensor:
        """One training step on a batch of `to_device` and the iteration
        counted; its metrics as one vector (`metric_keys`), on the device.
        With cfg.scan_steps > 1 on the card the step is a replay of the
        captured CUDA graph (`graph_step`); else it runs eagerly."""
        if self.cfg.scan_steps > 1 and self.device.type == "cuda":
            vec = self.graph_step(batch)
        else:
            vec = self._stacked_step(batch)
        self.iteration += 1
        return vec

    def graph_step(self, batch: dict) -> torch.Tensor:
        """The step as a replay of one captured CUDA graph: the batch is
        copied into the graph's static inputs (the banks must be the
        captured ones), the LR and update count written into their device
        tensors, the graph replayed. The first call runs the step eagerly
        on a side stream (a real step, which also makes cuBLAS's and
        cuDNN's plans and the model's cached buffers) and then captures it;
        the iteration is not counted here."""
        if self._graph is None:
            return self._capture(batch)
        graph = self._graph
        for key, src in batch.items():
            dst = graph["inputs"][key]
            if key in BANK_KEYS:
                if src is not dst:
                    raise ValueError(f"a replayed step takes the captured {key}; got another tensor")
            elif src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{key}: {src.dtype} {tuple(src.shape)}, the captured step's "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            else:
                dst.copy_(src, non_blocking=True)
        self.optimizer.write_inputs()
        graph["graph"].replay()
        self.optimizer.count += 1
        self.replays += 1
        return graph["metrics"].clone()

    def _capture(self, batch: dict) -> torch.Tensor:
        """The first graph step: the eager step on a side stream, then the
        capture. What would make a replay differ from the eager step, and
        what is done about it:
          * dropout and drop path draw from the card's default generator,
            which a capture registers itself; a module's own CUDA generator
            is registered here (`register_generator_state`), or every replay
            would repeat one mask;
          * autocast's cache of cast weights is off inside the capture
            (`steps._forward_context`);
          * the LR and the update count are device tensors written before
            each replay (`PolySGD.write_inputs`); the step reads no host
            value (no `.item()`, no data-dependent shape);
          * the gradients are set to None before the capture, so the
            backward makes them in the graph's memory and each replay
            rewrites them in place; a parameter that gets none takes the
            zero gradient `PolySGD` made at the eager step;
          * the window-attention and SGD kernels launch on the current
            stream, so the capture records them; their wrappers count the
            launches they record once, at the capture: `graph_launches` holds
            those counts, the launches of every replayed step;
          * cuDNN's algorithms are those the eager step chose
            (`cudnn.benchmark` stays off, and the plans are cached by
            shape);
          * other threads (a `Prefetcher` pinning memory) may call CUDA
            while the capture runs: the capture mode is "thread_local"."""
        device = self.device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            vec = self._stacked_step(batch)
        main.wait_stream(side)
        vec.record_stream(main)
        inputs = {k: t if k in BANK_KEYS else t.clone() for k, t in batch.items()}
        self.optimizer.zero_grad()
        count = self.optimizer.count
        graph = torch.cuda.CUDAGraph()
        for g in self._generators().values():
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        before = launch_counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics = self._stacked_step(inputs)
        after = launch_counts()
        self.optimizer.count = count
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self._graph = {"graph": graph, "inputs": inputs, "metrics": metrics}
        return vec

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
        the best dice from 0. Steps run in groups of up to cfg.scan_steps
        that never cross a validation, checkpoint or end boundary; once
        cfg.dispatch_depth groups are in flight the host waits for the
        oldest and logs its steps (every group before a validation, a
        checkpoint or the end). Returns {"log": one dict per
        logged step (iteration, seconds since the start when it was logged,
        lr, metrics), "vals": one dict per validation (iteration, mean_dice,
        mean_hd95, its seconds), "best_mean_dice", "best_path", "saves": one
        dict per train-state save (iteration, path, bytes, seconds)}."""
        cfg = self.cfg
        snapshot = cfg.snapshot_path
        logger = setup_logging(snapshot)
        writer = ScalarWriter(f"{snapshot}/log")
        try:
            return self._fit(train_batches, evaluate, class_names, logger, writer)
        finally:
            writer.close()

    def _group_size(self) -> int:
        """Steps in the next group: up to cfg.scan_steps, never past a
        validation, a checkpoint or the end (icl_tpu/train/trainer.py:
        326-338)."""
        cfg, it = self.cfg, self.iteration
        k = min(cfg.max_iterations - it, cfg.scan_steps)
        if cfg.val_interval:
            k = min(k, cfg.val_interval - it % cfg.val_interval)
        if cfg.checkpoint_interval:
            k = min(k, cfg.checkpoint_interval - it % cfg.checkpoint_interval)
        return k

    def _to_host(self, base: int, vecs: list) -> dict:
        """A dispatched group's record: its metrics copied to pinned host
        memory where any of its steps is logged, and an event after them
        (on the card)."""
        logged = any((base + r + 1) % self.cfg.log_interval == 0 for r in range(len(vecs)))
        host = None
        if logged:
            rows = torch.stack(vecs)
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
            else:
                host = rows
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"base": base, "n": len(vecs), "host": host, "event": event}

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
        pending: collections.deque = collections.deque()  # groups in flight, not yet logged
        t_start = time.perf_counter()

        def flush(group: dict) -> None:
            """Wait for a group that leaves the window, then log its steps."""
            if group["event"] is not None:
                group["event"].synchronize()
            if group["host"] is None:
                return
            for r, values in enumerate(group["host"].tolist()):
                it = group["base"] + r + 1
                if it % cfg.log_interval:
                    continue
                host = dict(zip(self.metric_keys, values))
                lr = self.optimizer.schedule(it - 1)
                log.append({"iteration": it, "seconds": time.perf_counter() - t_start, "lr": lr,
                            **host})
                writer.add_scalar("Info/lr", lr, it)
                for k, v in host.items():
                    writer.add_scalar(f"Loss/{k}", v, it)
                logger.info("iteration %d : " + ", ".join(f"{k}: {v:f}" for k, v in host.items()), it)

        def drain() -> None:
            while pending:
                flush(pending.popleft())

        running = True
        while running and self.iteration < cfg.max_iterations:
            group = []
            for _ in range(self._group_size()):
                try:
                    group.append(self.to_device(next(batch_iter)))
                except StopIteration:
                    running = False
                    break
            if not group:
                break
            base = self.iteration
            pending.append(self._to_host(base, [self.train_step(batch) for batch in group]))
            # at most dispatch_depth groups in flight while the host makes the next one; at
            # depth 1 each group is waited for and logged as soon as it is dispatched
            while len(pending) >= cfg.dispatch_depth:
                flush(pending.popleft())
            it = self.iteration
            if evaluate is not None and cfg.val_interval and it % cfg.val_interval == 0:
                drain()
                self.model.eval()
                t_val = time.perf_counter()
                agg = evaluate(_Promoted(self.model) if cfg.state_dtype == "bfloat16"
                               else self.model)
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
                drain()
                self._save_state(logger, saves, step=it)
        drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
