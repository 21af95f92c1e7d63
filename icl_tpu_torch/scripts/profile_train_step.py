"""Where the time of one SwinUNETR-ICL training step goes on the card.

    python -m icl_tpu_torch.scripts.profile_train_step [--precision float32]

Builds the trainer of the BraTS CLI (SwinUNETR-ICL fs48, 96^3 patches,
batch 4 of which 2 labeled, recompute on; seeded weights and seeded
synthetic 128^3 cases), runs two warm-up steps and then one profiled
step, and prints the device time by kernel group, the top kernels, the
step's wall time, the card's idle share over it and the peak memory,
then one JSON line with the same numbers. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.brats import brats_train_batches
from icl_tpu_torch.data.synth import synthetic_brats_cases
from icl_tpu_torch.scripts.profile_forward import device_time_by_group
from icl_tpu_torch.train.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = ExperimentConfig(root_path="in-memory", exp="profile", model="swinunetr_icl",
                           max_iterations=3, batch_size=4, labeled_bs=2, patch_size=(96, 96, 96),
                           labeled_num=2, consis_weight=10.0, precision=args.precision,
                           remat=True, feature_size=48)
    trainer = Trainer(cfg, device="cuda")
    cases = synthetic_brats_cases(4, 128, seed=0)
    batches = brats_train_batches(cases, 2, len(cases), cfg.batch_size, cfg.labeled_bs,
                                  cfg.patch_size, seed=cfg.seed)
    for _ in range(2):  # the first step makes the momentum buffers and cuDNN plans
        trainer.step_fn(trainer.to_device(next(batches)))
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
    print(f"training step SwinUNETR-ICL fs48, 96^3, batch 4 (2 labeled), {args.precision}, "
          f"recompute on: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels, peak memory "
          f"{peak / 2**30:.3f} GiB, loss {loss:.6f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / busy_ms:6.1%}  {g}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms:10.3f} ms  x{n:<4d} {name[:110]}")
    print(json.dumps({"card": card, "precision": args.precision, "wall_ms": wall_ms,
                      "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                      "peak_bytes": peak, "by_group_ms": by_group}))


if __name__ == "__main__":
    main()
