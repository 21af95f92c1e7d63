"""Seconds per `Trainer.fit` step with the batches made on the step's thread
and with them made on a `Prefetcher` thread, in turns.

    python -m icl_tpu_torch.scripts.time_fit [--model icl_swinunet] [--steps 6]

Builds the trainer of one training CLI as `profile_train_step.py` does
(seeded weights, seeded synthetic data, the CLI's batch and patch), then
runs `fit` over `--steps` batches four times from the same trainer:
plain, prefetched, prefetched, plain. The prefetched runs pin each batch
on the thread and copy it asynchronously, as the training CLIs do. Each
run prints its s/step after its first step (each step ends reading its
loss terms, as a logged step of a user's run does) and how long the
step's thread waited for each batch; then one JSON line with the same
numbers. Needs a CUDA device. Run as a file, it imports `icl_tpu_torch`
from PYTHONPATH. Snapshots go to `build/time_fit` in the checkout.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import torch

from icl_tpu_torch.data.pipeline import Prefetcher
from icl_tpu_torch.scripts.profile_train_step import setup
from icl_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(batches, waits: list):
    """The batches of `batches`, each `next` timed into `waits`."""
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(batches)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield batch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="icl_swinunet",
                   choices=["swinunetr_icl", "icl_swinunet", "icl_unet"])
    p.add_argument("--steps", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_fit needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg, make_batches, what = setup(args.model, "float32")
    cfg.max_iterations = 4 * args.steps
    cfg.experiments_dir = os.path.join(ROOT, "build", "time_fit")
    trainer = Trainer(cfg, device="cuda")
    runs = []
    for mode in ("plain", "prefetched", "prefetched", "plain"):
        waits: list = []
        batches = make_batches()
        if mode == "prefetched":
            batches = Prefetcher(batches, pin_memory=True)
        try:
            log = trainer.fit(itertools.islice(timed(batches, waits), args.steps))["log"]
        finally:
            if mode == "prefetched":
                batches.close()
        s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
        runs.append({"mode": mode, "s_per_step": s_per_step, "waits_s": waits})
        print(f"{mode}: {s_per_step:.4f} s/step after the first step; the step's thread waited "
              f"{[round(w, 4) for w in waits]} s for its batches", flush=True)
    print(f"card: {card}; {what}, f32, TF32 off, {args.steps} steps per run")
    print(json.dumps({"card": card, "model": args.model, "runs": runs}))


if __name__ == "__main__":
    main()
