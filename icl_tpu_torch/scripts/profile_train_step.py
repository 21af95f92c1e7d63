"""Where the time of one training step goes on the card.

    python -m icl_tpu_torch.scripts.profile_train_step [--model swinunetr_icl]
        [--precision float32] [--dataset brats]

Builds the trainer of one training CLI with seeded weights and seeded
synthetic data: `swinunetr_icl`, the BraTS CLI's (SwinUNETR-ICL fs48, 96^3
patches, batch 4 of which 2 labeled, recompute on, 128^3 cases),
`icl_swinunet`, the ACDC Swin CLI's at 384^2 with window 12 (Swin-UNet-ICL
embed 96, batch 16 of which 8 labeled, consistency weight 50, 256^2
slices), `icl_unet`, the ACDC U-Net CLI's defaults (U-Net-ICL at 256^2,
the same batch, weight and slices), or `unet_3D_icl`, the 3D U-Net CLI's
defaults: with `--dataset brats` the BraTS CLI's (U-Net-ICL 3D at 96^3,
batch 4 of which 2 labeled, 2 classes, consistency weight 10, on the 128^3
cases), with `--dataset amos` the AMOS CLI's (16 classes, base LR 0.02,
pse weight 0.1, recompute on, bf16 unless `--precision` says otherwise,
on the same cases with their tumour labelled as one of 15 organs); or a
fully supervised CLI's defaults: `unet` (256^2, batch 16) or `swinunet`
(224^2, window 7, batch 16) on the same slices, `swinunetr` (fs48, 96^3,
batch 4, recompute on, bf16 unless `--precision` says otherwise) on the
BraTS cases; or `fixmatch_cta`, the FixMatch-CTA CLI's defaults (the U-Net
at 256^2, batch 16 of which 8 labeled, threshold 0.95, the probe fused,
f32) on `cta_batches` of the same slices. `--state_dtype bfloat16`
stores the train state in bf16; `--input_mode device_bank` (the ACDC 2D
models) holds the slices on the card and gathers and augments each batch
inside the step; `--scan_steps K` > 1 also times the step as a replay of
its captured CUDA graph (`Trainer.graph_step`); `--dispatch_depth` is
taken for the trainer's config. Times building the model, runs two
warm-up steps, three timed steps without the profiler and then one
profiled step, each on a batch made before its clock starts (with
`--scan_steps` > 1: the graph's first step, three timed replays and one
profiled replay as well), and prints the build's and the timed steps'
seconds, the device time by kernel group, the top kernels, the launches,
the profiled step's wall time, the card's idle share over it and the peak
memory, then one JSON line with the same numbers. The fast configuration
of the flagship:

    python -m icl_tpu_torch.scripts.profile_train_step --model icl_unet --precision bfloat16 \
        --state_dtype bfloat16 --input_mode device_bank --scan_steps 4 --fuse_icl_pair

Needs a CUDA device. Run as a file, it imports `icl_tpu_torch`
from PYTHONPATH, so that another checkout's step can be timed by the same
code.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.scripts.profile_forward import device_time_by_group
from icl_tpu_torch.train.cta import CTATrainer
from icl_tpu_torch.train.trainer import Trainer


def brats_setup(precision: str, model: str = "swinunetr_icl", dataset: str = "brats"):
    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.data.synth import synthetic_brats_cases

    common = dict(root_path="in-memory", exp="profile", model=model, max_iterations=3, batch_size=4,
                  labeled_bs=2, patch_size=(96, 96, 96), labeled_num=2, consis_weight=10.0)
    cases = synthetic_brats_cases(4, 128, seed=0)
    if model == "swinunetr_icl":
        cfg = ExperimentConfig(**common, precision=precision, remat=True, feature_size=48)
        what = "SwinUNETR-ICL fs48, 96^3, batch 4 (2 labeled), recompute on"
    elif dataset == "brats":
        cfg = ExperimentConfig(**common, precision=precision)
        what = "U-Net-ICL 3D, 96^3, batch 4 (2 labeled), 2 classes (the BraTS CLI's)"
    else:
        cfg = ExperimentConfig(**common, num_classes=16, base_lr=0.02, pse_weight=0.1,
                               precision=precision, remat=True)
        what = ("U-Net-ICL 3D, 96^3, batch 4 (2 labeled), 16 classes, recompute on "
                "(the AMOS CLI's)")
        organs = np.random.default_rng(1).integers(1, 16, len(cases))
        cases = [{**c, "label": c["label"] * np.uint8(o)} for c, o in zip(cases, organs)]

    def make_batches():
        return brats_train_batches(cases, 2, len(cases), cfg.batch_size, cfg.labeled_bs,
                                   cfg.patch_size, seed=cfg.seed)

    return cfg, make_batches, what


def supervised_setup(precision: str, model: str):
    from icl_tpu_torch.data.brats import brats_supervised_batches
    from icl_tpu_torch.data.pipeline import supervised_batches
    from icl_tpu_torch.data.synth import synthetic_acdc, synthetic_brats_cases

    if model == "swinunetr":
        cfg = ExperimentConfig(root_path="in-memory", exp="profile", model=model, max_iterations=3,
                               batch_size=4, patch_size=(96, 96, 96), labeled_num=4,
                               precision=precision, remat=True, feature_size=48)
        cases = synthetic_brats_cases(4, 128, seed=0)
        what = "supervised SwinUNETR fs48, 96^3, batch 4, recompute on"

        def make_batches():
            return brats_supervised_batches(cases, cfg.batch_size, cfg.patch_size, seed=cfg.seed)

        return cfg, make_batches, what
    side = 224 if model == "swinunet" else 256
    cfg = ExperimentConfig(root_path="in-memory", exp="profile", model=model, num_classes=4,
                           max_iterations=3, batch_size=16, patch_size=(side, side),
                           labeled_num=7, precision=precision)
    slices, _ = synthetic_acdc(32, 0, 256, 1, 4, seed=0)
    what = ("supervised Swin-UNet embed 96, 224^2, window 7, batch 16" if model == "swinunet"
            else "supervised U-Net, 256^2, batch 16")

    def make_batches():
        return supervised_batches(slices, cfg.batch_size, cfg.patch_size, seed=cfg.seed)

    return cfg, make_batches, what


def acdc_setup(precision: str, model: str):
    from icl_tpu_torch.data.pipeline import acdc_train_batches
    from icl_tpu_torch.data.synth import synthetic_acdc
    from icl_tpu_torch.models.swin2d import SwinConfig

    if model == "icl_swinunet":
        side, kwargs = 384, {"swin_cfg": SwinConfig(img_size=384, window_size=12)}
        what = "Swin-UNet-ICL embed 96, 384^2, window 12, batch 16 (8 labeled)"
    else:
        side, kwargs, what = 256, {}, "U-Net-ICL, 256^2, batch 16 (8 labeled)"
    cfg = ExperimentConfig(root_path="in-memory", exp="profile", model=model, num_classes=4,
                           max_iterations=3, batch_size=16, labeled_bs=8, patch_size=(side, side),
                           labeled_num=7, consis_weight=50.0, precision=precision,
                           model_kwargs=kwargs)
    slices, _ = synthetic_acdc(32, 0, 256, 1, 4, seed=0)

    def make_batches():
        return acdc_train_batches(slices, 16, cfg.batch_size, cfg.labeled_bs, cfg.patch_size,
                                  seed=cfg.seed)

    return cfg, make_batches, what


def cta_setup():
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.data.synth import synthetic_acdc

    cfg = ExperimentConfig(root_path="in-memory", exp="profile", model="unet", num_classes=4,
                           max_iterations=3, batch_size=16, labeled_bs=8, patch_size=(256, 256),
                           labeled_num=7)
    slices, _ = synthetic_acdc(32, 0, 256, 1, 4, seed=0)

    def make_batches():
        return cta_batches(slices, 16, cfg.batch_size, cfg.labeled_bs, cfg.patch_size,
                           CTAugment(seed=cfg.seed), seed=cfg.seed)

    return cfg, make_batches, "FixMatch-CTA U-Net, 256^2, batch 16 (8 labeled), the probe fused"


def setup(model: str, precision: str, dataset: str = "brats"):
    """(cfg, make_batches, description) of the training CLI of `model` (on
    `dataset` for unet_3D_icl); make_batches() starts the seeded batch
    stream anew."""
    if model in ("swinunetr_icl", "unet_3D_icl"):
        return brats_setup(precision, model, dataset)
    if model in ("unet", "swinunet", "swinunetr"):
        return supervised_setup(precision, model)
    if model == "fixmatch_cta":
        return cta_setup()
    return acdc_setup(precision, model)


def bank_setup(cfg, model: str):
    """Bank batches of the setup's slices for the device_bank input mode
    (the ACDC 2D models): the slices on the card, indices and draws per
    step."""
    from icl_tpu_torch.data.device_bank import (bank_batches, build_acdc_bank,
                                                supervised_index_batches, two_stream_index_batches)
    from icl_tpu_torch.data.synth import synthetic_acdc

    slices, _ = synthetic_acdc(32, 0, 256, 1, 4, seed=0)
    image_bank, label_bank = build_acdc_bank(slices, int(cfg.patch_size[0]), "cuda")

    def make_batches():
        indices = (two_stream_index_batches(16, len(slices), cfg.batch_size, cfg.labeled_bs,
                                            seed=cfg.seed) if model.startswith("icl")
                   else supervised_index_batches(len(slices), cfg.batch_size, seed=cfg.seed))
        return bank_batches(image_bank, label_bank, indices, seed=cfg.seed)

    return make_batches


def profiled(step, batch) -> dict:
    """One step under torch.profiler: wall ms, device busy ms, idle share,
    kernels by group and name, launches, peak memory, loss."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, by_group, by_name, n_kernels = device_time_by_group(prof)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": n_kernels, "by_group_ms": by_group, "by_name": by_name,
            "peak_bytes": torch.cuda.max_memory_allocated(), "loss": float(metrics[0])}


def timed(step, batches, n: int = 3) -> list:
    """Seconds of n steps without the profiler, each on a batch made
    before its clock starts."""
    out = []
    for _ in range(n):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def report(kind: str, what: str, precision: str, step_s: list, prof: dict) -> None:
    print(f"{kind} step without the profiler: {step_s} s, mean {sum(step_s) / len(step_s):.4f} s")
    print(f"{kind} step {what}, {precision}: wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.3f}, {prof['kernels']} kernels, "
          f"peak memory {prof['peak_bytes'] / 2**30:.3f} GiB, loss {prof['loss']:.6f}")
    for g, ms in sorted(prof["by_group_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / max(prof['busy_ms'], 1e-9):6.1%}  {g}")
    print("top kernels:")
    for name, (ms, n) in sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:10.3f} ms  x{n:<4d} {name[:110]}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="swinunetr_icl",
                   choices=["swinunetr_icl", "icl_swinunet", "icl_unet", "unet_3D_icl", "unet",
                            "swinunet", "swinunetr", "fixmatch_cta"])
    p.add_argument("--precision", default=None, choices=["float32", "bfloat16"],
                   help="default: the CLI's (bfloat16 for swinunetr and --dataset amos, "
                        "else float32)")
    p.add_argument("--dataset", default="brats", choices=["brats", "amos"],
                   help="unet_3D_icl only: the BraTS or the AMOS CLI's configuration")
    p.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--input_mode", default="host", choices=["host", "device_bank"])
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--dispatch_depth", type=int, default=1)
    p.add_argument("--fuse_icl_pair", action="store_true")
    args = p.parse_args(argv)
    if args.precision is None:
        amos = args.model == "unet_3D_icl" and args.dataset == "amos"
        args.precision = "bfloat16" if amos or args.model == "swinunetr" else "float32"
    if args.model == "fixmatch_cta" and (args.precision != "float32" or args.scan_steps > 1
                                         or args.state_dtype != "float32"):
        raise SystemExit("the FixMatch-CTA step runs eagerly in float32 only, as its CLI")
    if args.input_mode == "device_bank" and args.model not in ("icl_unet", "unet"):
        raise SystemExit("--input_mode device_bank: the ACDC U-Nets (icl_unet, unet) only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg, make_batches, what = setup(args.model, args.precision, args.dataset)
    cfg.state_dtype, cfg.fuse_icl_pair = args.state_dtype, args.fuse_icl_pair
    cfg.scan_steps, cfg.dispatch_depth = args.scan_steps, args.dispatch_depth
    if args.input_mode == "device_bank":
        cfg.device_augment = True
        make_batches = bank_setup(cfg, args.model)
    what += (f", state {args.state_dtype}, input {args.input_mode}"
             + (", fused sspa pair" if args.fuse_icl_pair else ""))
    batches = make_batches()
    t0 = time.perf_counter()
    trainer = (CTATrainer if args.model == "fixmatch_cta" else Trainer)(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    device_batches = (trainer.to_device(b) for b in batches)
    for _ in range(2):  # the first step makes the zero gradients and cuDNN plans
        trainer._stacked_step(next(device_batches))
    eager_s = timed(trainer._stacked_step, device_batches)
    eager = profiled(trainer._stacked_step, next(device_batches))
    print(f"card: {card}")
    print(f"model built and initialised in {build_s:.2f} s, "
          f"{sum(p.numel() for p in trainer.model.parameters())} parameters")
    report("eager", what, args.precision, eager_s, eager)
    result = {"card": card, "model": args.model, "dataset": args.dataset,
              "precision": args.precision, "state_dtype": args.state_dtype,
              "input_mode": args.input_mode, "fuse_icl_pair": args.fuse_icl_pair,
              "build_s": build_s, "step_s": eager_s,
              **{k: v for k, v in eager.items() if k != "by_name"}}
    if args.scan_steps > 1:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer.graph_step(next(device_batches))  # the eager step on a side stream, the capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        pool = torch.cuda.memory_allocated() - before
        replay_s = timed(trainer.graph_step, device_batches)
        replay = profiled(trainer.graph_step, next(device_batches))
        print(f"graph: first step and capture {capture_s:.3f} s; memory held after it "
              f"{pool / 2**30:.3f} GiB more than before; launches recorded per replay "
              f"{trainer.graph_launches}")
        report("replayed", what, args.precision, replay_s, replay)
        result["graph"] = {"capture_s": capture_s, "pool_bytes": pool, "step_s": replay_s,
                           "launches_per_replay": trainer.graph_launches,
                           **{k: v for k, v in replay.items() if k != "by_name"}}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
