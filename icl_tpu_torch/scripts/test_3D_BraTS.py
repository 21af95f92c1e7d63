"""Offline BraTS2019 evaluation (counterpart of `scripts/test_3D_BraTS.py`):
sliding-window (96^3, stride 64) whole-tumour Dice/HD95 over val_test.

    python -m icl_tpu_torch.scripts.test_3D_BraTS --root_path ... --exp ...

`--model` is the trained model: `swinunetr_icl` (the default) or
`swinunetr` run a SwinUNETR of `--feature_size`, `unet_3D_icl` or
`unet_3D` a UNet3D. The checkpoint is a torch state_dict in the reference
key layout (default `<snapshot>/model/model_best.pth`, as the trainer
saves it: ICL heads stripped); the JAX package's msgpack checkpoints need
flax and are not read here. Runs on the CUDA card; `--device cpu` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.brats import BraTS2019Dataset
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.utils.convert import load_state_dict_file


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/BraTS2019")
    p.add_argument("--exp", type=str, default="BraTS2019/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="swinunetr_icl")
    p.add_argument("--feature_size", type=int, default=48)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--stride_xy", type=int, default=64)
    p.add_argument("--stride_z", type=int, default=64)
    p.add_argument("--labeled_num", type=int, default=25)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--test_list", type=str, default="val_test")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_eval_model(model: str, checkpoint: str, num_classes: int, device,
                    feature_size: int = 48):
    """The inference graph of `model` (`feature_size` is the SwinUNETR's),
    in eval mode, with the (stripped) checkpoint loaded strictly."""
    net = net_factory(model, in_chns=1, class_num=num_classes, device=device,
                      feature_size=feature_size, inference=True)
    net.load_state_dict(load_state_dict_file(checkpoint), strict=True)
    return net.eval()


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, patch_size=tuple(args.patch_size),
        labeled_num=args.labeled_num, num_tries=args.num_tries,
    )
    ckpt_path = args.checkpoint or os.path.join(cfg.snapshot_path, "model", "model_best.pth")
    device = resolve_device(args.device)
    model = load_eval_model(args.model, ckpt_path, args.num_classes, device, args.feature_size)

    db = BraTS2019Dataset(args.root_path, args.test_list)
    metric_cal = evaluate_brats_cases(
        make_patch_predictor(model), db, args.num_classes, cfg.patch_size,
        args.stride_xy, args.stride_z, sw_batch=4, device=device,
    )
    total = np.zeros(2)
    for ci in range(args.num_classes - 1):
        arr = np.asarray(metric_cal[ci])
        m, s = arr.mean(axis=0), arr.std(axis=0)
        total += m
        print(f"class {ci + 1}: dice {m[0]:.4f}±{s[0]:.4f}  hd95 {m[1]:.4f}±{s[1]:.4f}")
    total /= args.num_classes - 1
    print(f"MEAN: dice {total[0]:.4f}  hd95 {total[1]:.4f}")
    return total


if __name__ == "__main__":
    main()
