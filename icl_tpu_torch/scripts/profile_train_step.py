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
f32) on `cta_batches` of the same slices. Times
building the model, runs two
warm-up steps, three timed steps without the profiler and then one
profiled step, each on a batch made before its clock starts, and prints
the build's and the timed steps' seconds, the device time by kernel
group, the top kernels, the profiled step's wall time, the card's idle
share over it and the peak memory, then one JSON line with the same
numbers. Needs a CUDA device. Run as a file, it imports `icl_tpu_torch`
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
    args = p.parse_args(argv)
    if args.precision is None:
        amos = args.model == "unet_3D_icl" and args.dataset == "amos"
        args.precision = "bfloat16" if amos or args.model == "swinunetr" else "float32"
    if args.model == "fixmatch_cta" and args.precision != "float32":
        raise SystemExit("the FixMatch-CTA step runs in float32 only, as its CLI")
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg, make_batches, what = setup(args.model, args.precision, args.dataset)
    batches = make_batches()
    t0 = time.perf_counter()
    trainer = (CTATrainer if args.model == "fixmatch_cta" else Trainer)(cfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for _ in range(2):  # the first step makes the momentum buffers and cuDNN plans
        trainer.step_fn(trainer.to_device(next(batches)))
    step_s = []
    for _ in range(3):
        batch = trainer.to_device(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_fn(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    batch = trainer.to_device(next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = trainer.step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    busy_ms, by_group, by_name, n_kernels = device_time_by_group(prof)

    print(f"card: {card}")
    print(f"model built and initialised in {build_s:.2f} s, "
          f"{sum(p.numel() for p in trainer.model.parameters())} parameters")
    print(f"training step without the profiler: {step_s} s, mean {sum(step_s) / len(step_s):.4f} s")
    print(f"training step {what}, {args.precision}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels, peak memory "
          f"{peak / 2**30:.3f} GiB, loss {loss:.6f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / busy_ms:6.1%}  {g}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:10.3f} ms  x{n:<4d} {name[:110]}")
    print(json.dumps({"card": card, "model": args.model, "dataset": args.dataset,
                      "precision": args.precision,
                      "build_s": build_s, "step_s": step_s, "wall_ms": wall_ms,
                      "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                      "peak_bytes": peak, "by_group_ms": by_group}))


if __name__ == "__main__":
    main()
