"""Seconds per `Trainer.fit` step, in turns: with the batches made on the
step's thread and on a `Prefetcher` thread; or, with `--scan_steps` K > 1
or `--dispatch_depth` D > 1, one step at a time against groups of K
(replays of the step's captured CUDA graph) with D in flight.

    python -m icl_tpu_torch.scripts.time_fit [--model icl_swinunet] [--steps 6]
    python -m icl_tpu_torch.scripts.time_fit --model icl_unet --precision bfloat16 \
        --state_dtype bfloat16 --input_mode device_bank --scan_steps 4 --dispatch_depth 2 \
        --fuse_icl_pair --steps 16

Builds the trainer of one training CLI as `profile_train_step.py` does
(seeded weights, seeded synthetic data, the CLI's batch and patch, and
its `--precision`, `--state_dtype`, `--input_mode` and `--fuse_icl_pair`).
Without the dispatch flags it runs `fit` over `--steps` batches four times
from one trainer: plain, prefetched, prefetched, plain (the prefetched
runs pin each batch on the thread and copy it asynchronously, as the
training CLIs do); each run prints its s/step after its first step and how
long the step's thread waited for each batch. With them it builds two
trainers, one step at a time and the given K and D, and runs a warm-up
`fit` of one group and then timed ones of `--steps` steps: eager, grouped,
grouped, eager; each prints its s/step over the whole `fit` (the metrics of
every step read back, the final train-state save left out). Then one JSON
line with the same numbers. Needs a CUDA device. Run as a file, it
imports `icl_tpu_torch` from PYTHONPATH. Snapshots go to `build/time_fit`
in the checkout.
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
from icl_tpu_torch.scripts.profile_train_step import bank_setup, setup
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
                   choices=["swinunetr_icl", "icl_swinunet", "icl_unet", "unet", "swinunet",
                            "unet_3D_icl"])
    p.add_argument("--dataset", default="brats", choices=["brats", "amos"])
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--input_mode", default="host", choices=["host", "device_bank"])
    p.add_argument("--scan_steps", type=int, default=1)
    p.add_argument("--dispatch_depth", type=int, default=1)
    p.add_argument("--fuse_icl_pair", action="store_true")
    p.add_argument("--steps", type=int, default=6)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_fit needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    def build(tries: str, scan_steps: int, dispatch_depth: int):
        cfg, make_batches, what = setup(args.model, args.precision, args.dataset)
        cfg.state_dtype, cfg.fuse_icl_pair = args.state_dtype, args.fuse_icl_pair
        cfg.scan_steps, cfg.dispatch_depth = scan_steps, dispatch_depth
        cfg.max_iterations = 100 * args.steps
        cfg.experiments_dir, cfg.num_tries = os.path.join(ROOT, "build", "time_fit"), tries
        if args.input_mode == "device_bank":
            cfg.device_augment = True
            make_batches = bank_setup(cfg, args.model)
        torch.manual_seed(0)
        return Trainer(cfg, device="cuda"), make_batches, what

    runs = []
    if args.scan_steps == 1 and args.dispatch_depth == 1:
        trainer, make_batches, what = build("prefetch", 1, 1)
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
    else:
        trainers = {"eager": build("eager", 1, 1), "grouped": build(
            "grouped", args.scan_steps, args.dispatch_depth)}
        for mode in ("eager", "grouped"):  # warm-up: cuDNN plans, the capture
            trainer, make_batches, what = trainers[mode]
            trainer.fit(itertools.islice(make_batches(), args.scan_steps))
        for mode in ("eager", "grouped", "grouped", "eager"):
            trainer, make_batches, what = trainers[mode]
            batches = list(itertools.islice(make_batches(), args.steps))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = trainer.fit(batches)
            wall = time.perf_counter() - t0 - sum(s["seconds"] for s in result["saves"])
            runs.append({"mode": mode, "s_per_step": wall / args.steps, "steps": args.steps,
                         "replays": trainer.replays})
            print(f"{mode} (scan_steps {trainer.cfg.scan_steps}, dispatch_depth "
                  f"{trainer.cfg.dispatch_depth}): {wall / args.steps:.4f} s/step over {args.steps} "
                  f"steps", flush=True)
    print(f"card: {card}; {what}, {args.precision}, state {args.state_dtype}, input "
          f"{args.input_mode}, {args.steps} steps per run")
    print(json.dumps({"card": card, "model": args.model, "precision": args.precision,
                      "state_dtype": args.state_dtype, "input_mode": args.input_mode,
                      "scan_steps": args.scan_steps, "dispatch_depth": args.dispatch_depth,
                      "runs": runs}))


if __name__ == "__main__":
    main()
