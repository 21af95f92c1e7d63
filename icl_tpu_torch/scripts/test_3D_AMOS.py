"""Offline AMOS22 evaluation (counterpart of `scripts/test_3D_AMOS.py`): the
AMOS sliding window (96^3, stride 72, sw_batch 4, input rounded to bf16,
logits stitched), per-organ Dice/HD95 over validation[val_num:].

    python -m icl_tpu_torch.scripts.test_3D_AMOS --root_path ... --split_path ... --exp ...

The checkpoint is a torch state_dict in the reference key layout (default
`<snapshot>/model/model_best.pth`, as the trainer saves it: ICL heads
stripped), loaded strictly into the `UNet3D` that `--model` runs at
inference; the JAX package's msgpack checkpoints need flax and are not
read here. Runs on the CUDA card; `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.amos import AMOS_CLASS_NAMES, AMOSDataset, load_decathlon_datalist
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.eval.infer3d import evaluate_amos_cases, make_patch_predictor
from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/AMOS22")
    p.add_argument("--split_path", type=str, default="../data/AMOS22/dataset_semi_ct.json")
    p.add_argument("--exp", type=str, default="AMOS22/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="unet_3D_icl")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--labeled_num", type=int, default=30)
    p.add_argument("--val_num", type=int, default=30,
                   help="the test split is validation[val_num:] (test_3D_AMOS.py:153)")
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, patch_size=tuple(args.patch_size),
        labeled_num=args.labeled_num, num_tries=args.num_tries,
    )
    val_files = load_decathlon_datalist(args.split_path, "validation")[args.val_num:]
    if not val_files:
        raise SystemExit(f"empty test split: validation[{args.val_num}:] has no cases (the "
                         f"reference evaluates validation[val_num:]; lower --val_num)")
    ckpt_path = args.checkpoint or os.path.join(cfg.snapshot_path, "model", "model_best.pth")
    device = resolve_device(args.device)
    model = load_eval_model(args.model, ckpt_path, args.num_classes, device)

    scores_fn = make_patch_predictor(model, apply_softmax=False, dtype=torch.bfloat16)
    metric_cal = evaluate_amos_cases(scores_fn, AMOSDataset(val_files, val_mode=True),
                                     args.num_classes, cfg.patch_size, sw_batch=4, device=device)
    total = np.zeros(2)
    for ci in range(args.num_classes - 1):
        arr = np.asarray(metric_cal[ci])
        m, s = arr.mean(axis=0), arr.std(axis=0)
        total += m
        name = AMOS_CLASS_NAMES[ci] if ci < len(AMOS_CLASS_NAMES) else str(ci + 1)
        print(f"{name}: dice {m[0]:.4f}±{s[0]:.4f}  hd95 {m[1]:.4f}±{s[1]:.4f}")
    total /= args.num_classes - 1
    print(f"MEAN: dice {total[0]:.4f}  hd95 {total[1]:.4f}")
    return total


if __name__ == "__main__":
    main()
