"""Offline ACDC evaluation (counterpart of `scripts/test_2D_ACDC.py`):
per-class and mean Dice / HD95 of the best checkpoint over the val_test
volumes, through the 2D slice predictor.

    python -m icl_tpu_torch.scripts.test_2D_ACDC --root_path ../ACDC \\
        --exp ACDC/ICL --labeled_num 7
    python -m icl_tpu_torch.scripts.test_2D_ACDC --root_path ../ACDC --exp ACDC/SwinICL \\
        --labeled_num 7 --model icl_swinunet --cfg my_window12.yaml --patch_size 384 384

The checkpoint is a torch state_dict in the reference key layout (default
`<snapshot>/model/model_best.pth`, as the trainer saves it: ICL heads
stripped), loaded strictly into the model's inference graph (`UNet` for
`icl_unet`, the default, at 256 256; `SwinUnetWrapper` for
`icl_swinunet`). `--cfg` gives the Swin geometry an `icl_swinunet` was
trained with, as the training CLI takes it; the JAX script has no such
flag and builds the default geometry. Runs on the CUDA card; `--device
cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset
from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.eval.infer2d import make_slice_predictor
from icl_tpu_torch.metrics import calculate_metric_percase
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swin_config import swin_cli_kwargs
from icl_tpu_torch.train.trainer import ACDC_CLASS_NAMES
from icl_tpu_torch.utils.convert import load_state_dict_file


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="icl_unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_eval_model(model: str, checkpoint: str, num_classes: int, device, patch_size,
                    model_kwargs: dict | None = None):
    """The inference graph of `model`, in eval mode, with the (stripped)
    checkpoint loaded strictly. ICL models take the patch as their image
    side (test_2D_ACDC.py:59-61)."""
    kwargs = dict(model_kwargs or {})
    if model.startswith("icl_"):
        kwargs["patch_size"] = int(patch_size[0])
    net = net_factory(model, in_chns=1, class_num=num_classes, device=device, inference=True,
                      **kwargs)
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
    model = load_eval_model(args.model, ckpt_path, args.num_classes, device, cfg.patch_size,
                            swin_cli_kwargs(args))
    predict = make_slice_predictor(model, cfg.patch_size, device)

    db = ACDCDataset(args.root_path, "val_test")
    per_class = [[] for _ in range(args.num_classes - 1)]
    for i in range(len(db)):
        item = db[i]
        pred = predict(item["image"])
        for cls in range(1, args.num_classes):
            per_class[cls - 1].append(calculate_metric_percase(pred == cls, item["label"] == cls))
        print(f"{item['case']}: done")

    names = ACDC_CLASS_NAMES if args.num_classes == 4 else [
        str(i) for i in range(1, args.num_classes)]
    total = np.zeros(2)
    for ci, name in enumerate(names):
        arr = np.asarray(per_class[ci])
        m, s = arr.mean(axis=0), arr.std(axis=0)
        total += m
        print(f"{name}: dice {m[0]:.4f}±{s[0]:.4f}  hd95 {m[1]:.4f}±{s[1]:.4f}")
    total /= len(names)
    print(f"MEAN: dice {total[0]:.4f}  hd95 {total[1]:.4f}")
    return total


if __name__ == "__main__":
    main()
