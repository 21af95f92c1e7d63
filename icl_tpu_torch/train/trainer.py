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

Under data parallelism (a group of more than one process, made by
`parallel.multihost.initialize_from_args`) each process holds a replica and
steps on its rows of the global batch; the optimizer reduces the update's
gradient over the group (`PolySGD.step`), so the replicas stay equal. As in the JAX trainer (:236-245, :405-420) only
rank 0 logs, writes scalars, validates and saves; the others wait for it in
a barrier after each validation and each save. Step groups run one step at
a time there (no CUDA graph: the collectives run on the host's schedule).
Dropout and drop-path masks come from torch's default generators seeded per
(seed, rank).

Under tensor parallelism (`Trainer(cfg, mesh=create_mesh(data=D,
model=M))`, the JAX signature) the D x M processes form the mesh of
`parallel.mesh`: each data rank steps on its rows, as above, and the M
ranks of its model group hold the shards of the leaves `PARAM_RULES`
split (`shard_model`: the whole model is built from the seed on every
rank, then each keeps its slice), the collectives of `parallel.tensor`
inside the forward and backward. Row layouts, seeds and the gradient
reduction take the data rank and size, so the replicas of a model group
draw the same dropout masks. Validation runs on every rank of data rank
0's model group (its forward holds model-group collectives), rank 0 alone
logging and saving; the other data ranks wait, as under data parallelism.
Train states and the best model are written in the one-process layout
(`utils.checkpoint.gather_train_state`) and restored from it at any M.

`cfg.grad_accum` > 1 is the JAX trainer's optax.MultiSteps (:76-79): each
update applies the mean gradient of that many micro-steps (`PolySGD`), the
train state carries the accumulator and the micro-step index, and a group
of replays alternates the two captured graphs of a window. With
`cfg.log_flops` the first eager step is counted (`utils/flops.py`) and
`fit` logs the JAX trainer's two FLOP lines (:377-381, :476-483).
"""
from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.device_augment import AUGMENT_KEYS, augment_batch
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.parallel.collectives import barrier, broadcast_object
from icl_tpu_torch.parallel.mesh import Mesh, create_mesh, shard_model, world_group
from icl_tpu_torch.parallel.multihost import host_rows
from icl_tpu_torch.parallel.tensor import param_splits
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import forward, make_icl_step, make_supervised_step
from icl_tpu_torch.utils import checkpoint as ckpt
from icl_tpu_torch.utils.logging_utils import NullWriter, ScalarWriter, setup_logging

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


def rank_seed(*key: int) -> int:
    """A seed for torch's generators from a key such as (seed, rank) or
    (seed, rank, iteration) (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


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
    stochastic-rounding kernel; the step runs on upcast copies, held
    across its forward and backward (`steps.upcast_parameters`), so that
    `cfg.remat`'s recompute sees what the first forward saw. With
    `cfg.device_augment` the step takes raw slices or a bank with indices,
    and the augment draws (`to_device`). `mesh` is the JAX signature's
    (`parallel.mesh.create_mesh(data, model)`; by default
    `create_mesh(device=device)`, every process on the data axis). Under
    more than one process `device` "cuda" means this rank's card, the model
    must be an ICL model, the step takes this data rank's rows
    (`parallel.multihost.host_rows`), and the device augment is refused
    (the bank lives on one card); with a model axis the model is sharded
    (`parallel.mesh.shard_model`)."""

    def __init__(self, cfg: ExperimentConfig, device=None,
                 generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None):
        if cfg.model not in ICL_MODELS + SUPERVISED_MODELS:
            raise KeyError(f"model {cfg.model!r}: the port trains "
                           f"{list(ICL_MODELS + SUPERVISED_MODELS)} only")
        self.cfg = cfg
        self.mesh = create_mesh(device=device) if mesh is None else mesh
        self.device = self.mesh.device
        labeled_bs = cfg.labeled_bs
        if self.mesh.process_count > 1:
            if cfg.model not in ICL_MODELS:
                raise ValueError(f"model {cfg.model!r}: multi-process training is ported for the "
                                 f"ICL models {list(ICL_MODELS)} only")
            if cfg.device_augment:
                raise ValueError("device_augment (--input_mode device_bank) holds the bank on one "
                                 "card; use --input_mode host for multi-process runs")
        if self.mesh.size > 1:
            host_rows(cfg.batch_size, cfg.labeled_bs, self.mesh.rank, self.mesh.size)
            labeled_bs = cfg.labeled_bs // self.mesh.size
            torch.manual_seed(rank_seed(cfg.seed, self.mesh.rank))
        if cfg.precision == "float32" and self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        # ICL models take the training patch (icl_tpu/train/trainer.py:58-63)
        model_kwargs = dict(cfg.model_kwargs)
        if cfg.fuse_icl_pair:
            model_kwargs["fuse_sspa_pair"] = True
        if cfg.device_augment and len(cfg.patch_size) != 2:
            raise ValueError("device_augment is 2D-only")
        # under tensor parallelism the whole model is built on the host and
        # sharded there, so that a rank's card holds its shard only
        sharded = self.mesh.model_size > 1
        self.model = net_factory(cfg.model, cfg.in_chns, cfg.num_classes,
                                 device="cpu" if sharded else self.device, generator=generator,
                                 feature_size=cfg.feature_size, patch_size=int(cfg.patch_size[0]),
                                 remat=cfg.remat, **model_kwargs)
        if sharded:
            self.model = shard_model(self.model, self.mesh).to(self.device)
        if cfg.state_dtype == "bfloat16":
            for p in self.model.parameters():
                p.data = p.data.to(torch.bfloat16)
        splits = param_splits(self.model)
        self.optimizer = PolySGD(self.model.parameters(), cfg.base_lr, cfg.max_iterations,
                                 cfg.momentum, cfg.weight_decay, cfg.poly_power,
                                 state_dtype=cfg.state_dtype, grad_accum=cfg.grad_accum,
                                 shards=[splits.get(n) for n, _ in self.model.named_parameters()])
        if cfg.model in ICL_MODELS:
            self.step_fn = make_icl_step(self.model, self.optimizer, cfg.num_classes,
                                         labeled_bs, cfg.patch_size, cfg.consis_weight,
                                         cfg.pse_weight, cfg.precision)
        else:
            self.step_fn = make_supervised_step(self.model, self.optimizer, cfg.num_classes,
                                                cfg.seg_weight, cfg.precision)
        if cfg.device_augment:
            self.step_fn = self._augmenting(self.step_fn)
        self.iteration = 0
        self.metric_keys: tuple = ()
        # the captured steps by kind ("update"; with grad_accum > 1 also
        # "accumulate"), their static inputs and their memory pool
        self._graphs: dict = {}
        self._graph_inputs: Optional[dict] = None
        self._graph_pool = None
        self.replays = 0
        # the analytic FLOPs of one step, counted at the first eager step
        # when cfg.log_flops is set (`utils.flops`)
        self.step_flops: Optional[float] = None

    @property
    def graph_launches(self) -> dict:
        """The kernel launches recorded in the captured update step, which
        each of its replays runs ({} before the capture)."""
        graph = self._graphs.get("update")
        return dict(graph["launches"]) if graph else {}

    @property
    def scan_steps(self) -> int:
        """cfg.scan_steps, or 1 under more than one process (the JAX
        trainer's fallback, icl_tpu/train/trainer.py:282-287)."""
        return 1 if self.mesh.process_count > 1 else self.cfg.scan_steps

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
        the card, and of the model's own generators. Under tensor
        parallelism the model's and the optimizer's tensors are this rank's
        shards (`utils.checkpoint.gather_train_state` gathers them)."""
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
        the step stays valid. A state of another `state_dtype` raises. Under
        data parallelism the state holds rank 0's generators; every rank
        then seeds torch's generators from (seed, data rank, iteration)
        instead. Under tensor parallelism `state` is in the one-process
        layout, as every file is, and each rank takes its slice."""
        saved = state.get("state_dtype", "float32")
        if saved != self.cfg.state_dtype:
            raise ValueError(f"the train state's state_dtype is {saved!r}, the trainer's "
                             f"{self.cfg.state_dtype!r}")
        state = ckpt.shard_train_state(state, self.model, self.optimizer)
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
        if self.mesh.size > 1:  # rank 0's generators were saved: each rank draws its own again
            torch.manual_seed(rank_seed(self.cfg.seed, self.mesh.rank, self.iteration))

    def restore_state(self, name: str = "last") -> int:
        """Resume from `<snapshot>/model/state_{name}.pt` (counterpart of
        `restore_state`, icl_tpu/train/trainer.py:198-218), mapped to the
        trainer's device; `fit` then continues from its iteration, which
        is returned."""
        self.load_train_state(ckpt.load_train_state(self.cfg.snapshot_path, name, self.device))
        return self.iteration

    def _save_state(self, logger, saves: list, step: Optional[int] = None) -> None:
        """The rolling step file (`step` given) or `state_last`, timed; the
        state gathered by data rank 0's model group and written by rank 0
        alone, the others waiting for it."""
        world = world_group()
        if self.mesh.rank:
            barrier(world)
            return
        snapshot = self.cfg.snapshot_path
        t0 = time.perf_counter()
        state = ckpt.gather_train_state(self.train_state(), self.model, self.optimizer)
        if self.mesh.process_index:
            barrier(world)
            return
        nbytes = ckpt.state_bytes(state)
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
        barrier(world)

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
        captured CUDA graph (`graph_step`); else it runs eagerly. With
        cfg.log_flops the first eager step is counted (`count_step_flops`)."""
        if self.scan_steps > 1 and self.device.type == "cuda":
            vec = self.graph_step(batch)
        elif self.cfg.log_flops and self.step_flops is None:
            vec = self.count_step_flops(batch)
        else:
            vec = self._stacked_step(batch)
        self.iteration += 1
        return vec

    def count_step_flops(self, batch: dict) -> torch.Tensor:
        """`_stacked_step(batch)` with its matmul and convolution FLOPs
        counted (`utils.flops.counting`: the kernels' by formula) into
        `step_flops`, summed over the data ranks; under tensor parallelism
        the model group's sharded work (`parallel.tensor.is_sharded_module`)
        is summed over its ranks and its replicated work counted once, so
        that the count is the one-process count. The count runs the same
        kernels as any step."""
        from icl_tpu_torch.parallel.collectives import all_reduce_sum, group_device
        from icl_tpu_torch.utils.flops import counting

        with counting(self.model) as count:
            vec = self._stacked_step(batch)
        mesh = self.mesh
        # this rank's share: its shards' work, and 1/M of the work every rank repeats
        share = count.sharded + (count.total - count.sharded) / mesh.model_size
        group = mesh.model_group or mesh.group
        total = torch.tensor(share, dtype=torch.float64,
                             device=group_device(group) if group is not None else "cpu")
        if mesh.model_group is not None:
            total = all_reduce_sum(total, mesh.model_group)
        self.step_flops = float(all_reduce_sum(total))
        return vec

    def graph_step(self, batch: dict) -> torch.Tensor:
        """The step as a replay of a captured CUDA graph: the batch is
        copied into the graphs' static inputs (the banks must be the
        captured ones), the optimizer's device inputs written, the graph
        replayed. With cfg.grad_accum > 1 a window has two kinds of step,
        one that only accumulates and the one that also updates; one graph
        of each is captured, in one memory pool, and the host's micro-step
        index (`PolySGD.updates_now`) picks the graph. The first call of
        each kind runs the step eagerly on a side stream (a real step, which
        also makes cuBLAS's and cuDNN's plans and the model's cached
        buffers) and then captures it; the iteration is not counted here."""
        kind = "update" if self.optimizer.updates_now else "accumulate"
        graph = self._graphs.get(kind)
        if graph is None:
            return self._capture(batch, kind)
        for key, src in batch.items():
            dst = self._graph_inputs[key]
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
        self.optimizer.advance()
        self.replays += 1
        return graph["metrics"].clone()

    def _capture(self, batch: dict, kind: str) -> torch.Tensor:
        """The first graph step of `kind`: the eager step on a side stream
        (counted by `count_step_flops` when cfg.log_flops asks and nothing
        is counted yet), then the capture. What would make a replay differ
        from the eager step, and what is done about it:
          * dropout and drop path draw from the card's default generator,
            which a capture registers itself; a module's own CUDA generator
            is registered here (`register_generator_state`), or every replay
            would repeat one mask;
          * autocast's cache of cast weights is off, in the eager step too
            (`steps._forward_context`): with it, a weight used twice has
            one cast whose bf16 gradients are summed in bf16, without it
            two casts summed in f32, and a capture cannot keep the cache;
          * the LR, the update count and the micro-step's divisor are
            device tensors written before each replay
            (`PolySGD.write_inputs`); the step reads no host value (no
            `.item()`, no data-dependent shape), and which graph runs is the
            host's micro-step index;
          * the gradients are set to None before the capture, so the
            backward makes them in the graph's memory and each replay
            rewrites them in place; a parameter that gets none takes the
            zero gradient `PolySGD` made at the eager step;
          * the two kinds of step share the static inputs and the memory
            pool; what one replay leaves in the pool the other never reads
            (the parameters, momentum, accumulators and running stats live
            outside it, and each replay's metrics are copied out at once);
          * the recompute of a checkpointed block (`layers.call_remat`)
            runs in the backward inside the capture and is recorded with
            it; it draws no random numbers (the 3D U-Net's dropouts sit
            between the recomputed blocks) and casts its weights again, as
            the eager recompute does with the cache off;
          * the window-attention and SGD kernels launch on the current
            stream, so the capture records them; their wrappers count the
            launches they record once, at the capture: `graph_launches` holds
            those of the update step, the launches of every replayed update;
          * cuDNN's algorithms are those the eager step chose
            (`cudnn.benchmark` stays off, and the plans are cached by
            shape);
          * other threads (a `Prefetcher` pinning memory) may call CUDA
            while the capture runs: the capture mode is "thread_local"."""
        device = self.device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        before = (self.optimizer.count, self.optimizer.micro)
        with torch.cuda.stream(side):
            if self.cfg.log_flops and self.step_flops is None:
                vec = self.count_step_flops(batch)
            else:
                vec = self._stacked_step(batch)
        main.wait_stream(side)
        vec.record_stream(main)
        after = (self.optimizer.count, self.optimizer.micro)
        if self._graph_inputs is None:
            self._graph_inputs = {k: t if k in BANK_KEYS else t.clone() for k, t in batch.items()}
            self._graph_pool = torch.cuda.graph_pool_handle()
        self.optimizer.zero_grad()
        # the capture records the branch of the step it replaces
        self.optimizer.count, self.optimizer.micro = before
        graph = torch.cuda.CUDAGraph()
        for g in self._generators().values():
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        counts = launch_counts()
        with torch.cuda.graph(graph, pool=self._graph_pool, capture_error_mode="thread_local"):
            metrics = self._stacked_step(self._graph_inputs)
        self.optimizer.count, self.optimizer.micro = after
        launched = launch_counts()
        self._graphs[kind] = {"graph": graph, "metrics": metrics,
                              "launches": {k: launched[k] - counts[k] for k in launched}}
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
        dict per train-state save (iteration, path, bytes, seconds),
        "step_flops": the analytic FLOPs of one step (cfg.log_flops; None
        when not counted), "seconds": the run's wall time}. With
        cfg.log_flops, log.txt gets the JAX trainer's two lines: the step's
        analytic GFLOP after the first group, and the run's end-to-end
        analytic TFLOP/s in the finished line. The logged LR of a step is
        that of the update it belongs to (with cfg.grad_accum > 1, one
        update per window); the JAX trainer logs lr(iteration - 1)
        whatever cfg.grad_accum."""
        cfg = self.cfg
        snapshot = cfg.snapshot_path
        if self.mesh.process_index == 0:
            logger = setup_logging(snapshot)
            writer = ScalarWriter(f"{snapshot}/log")
        else:
            logger = logging.getLogger(f"icl_tpu_torch.rank{self.mesh.process_index}")
            logger.propagate = False
            writer = NullWriter()
        try:
            return self._fit(train_batches, evaluate, class_names, logger, writer)
        finally:
            writer.close()

    def _group_size(self) -> int:
        """Steps in the next group: up to cfg.scan_steps, never past a
        validation, a checkpoint or the end (icl_tpu/train/trainer.py:
        326-338)."""
        cfg, it = self.cfg, self.iteration
        k = min(cfg.max_iterations - it, self.scan_steps)
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
        if cfg.scan_steps > 1 and self.mesh.process_count > 1:
            logger.info("scan_steps>1 unsupported under multi-process; falling back to per-step "
                        "dispatch")
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
                lr = group["lrs"][r]
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
        flops_logged = False
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
            vecs, lrs = [], []
            for batch in group:
                lrs.append(self.optimizer.schedule(self.optimizer.count))  # its update's LR
                vecs.append(self.train_step(batch))
            pending.append({**self._to_host(base, vecs), "lrs": lrs})
            if self.step_flops is not None and not flops_logged:
                flops_logged = True
                logger.info("analytic step cost: %.1f GFLOP (2MNK matmul + conv count of the first "
                            "step, incl. remat recompute)", self.step_flops / 1e9)
            # at most dispatch_depth groups in flight while the host makes the next one; at
            # depth 1 each group is waited for and logged as soon as it is dispatched
            while len(pending) >= cfg.dispatch_depth:
                flush(pending.popleft())
            it = self.iteration
            if evaluate is not None and cfg.val_interval and it % cfg.val_interval == 0:
                drain()
                if self.mesh.rank == 0:  # data rank 0's model group; rank 0 alone writes
                    self.model.eval()
                    t_val = time.perf_counter()
                    agg = evaluate(_Promoted(self.model) if cfg.state_dtype == "bfloat16"
                                   else self.model)
                    # the model ranks' maps may part in the last bits (index_add_ stitches
                    # with atomics on the card): model rank 0's decides for the group, so
                    # every rank takes the same branch into save_best_model's collectives
                    agg = broadcast_object(agg, self.mesh.model_ranks()[0], self.mesh.model_group)
                    val_s = time.perf_counter() - t_val
                    self.model.train()
                    vals.append({"iteration": it, "mean_dice": agg["mean_dice"],
                                 "mean_hd95": agg["mean_hd95"], "seconds": val_s})
                    for k in ("mean_dice", "mean_hd95", "std_dice", "std_hd95"):
                        writer.add_scalar(f"metric_all/{k}", agg[k], it)
                    for name, (dice, hd95) in zip(class_names, agg["class_mean"]):
                        writer.add_scalar(f"metric_class_{name}/mean_dice", dice, it)
                        writer.add_scalar(f"metric_class_{name}/mean_hd95", hd95, it)
                        logger.info("iteration %d : class %s : dice %f  hd95 %f", it, name, dice,
                                    hd95)
                    logger.info("iteration %d : mean_dice : %f  mean_hd95 : %f  (%.2f s)",
                                it, agg["mean_dice"], agg["mean_hd95"], val_s)
                    if agg["mean_dice"] > best:
                        best = agg["mean_dice"]
                        best_path = ckpt.save_best_model(snapshot, self.model)
                        logger.info("saving best model at iter %d -> %s", it, best_path)
                barrier(world_group())  # the other ranks wait for the validation
            if cfg.checkpoint_interval and it % cfg.checkpoint_interval == 0:
                drain()
                self._save_state(logger, saves, step=it)
        drain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t_start
        if cfg.log_flops and self.step_flops:
            # end to end: validations, saves and logging included
            logger.info("Training finished: %d iters in %.1fs (%.2f it/s, end-to-end analytic %.2f "
                        "TFLOP/s at %.1f GFLOP/step)", self.iteration, elapsed,
                        self.iteration / max(elapsed, 1e-9),
                        self.step_flops * self.iteration / max(elapsed, 1e-9) / 1e12,
                        self.step_flops / 1e9)
        else:
            logger.info("Training finished: %d iters in %.1fs (%.2f it/s)",
                        self.iteration, elapsed, self.iteration / max(elapsed, 1e-9))
        self._save_state(logger, saves)
        return {"log": log, "vals": vals, "best_mean_dice": best, "best_path": best_path,
                "saves": saves, "step_flops": self.step_flops, "seconds": elapsed}


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
