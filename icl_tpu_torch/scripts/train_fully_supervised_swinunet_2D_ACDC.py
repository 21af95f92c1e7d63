"""Fully supervised Swin-UNet 2D on ACDC (counterpart of
`scripts/train_fully_supervised_swinunet_2D_ACDC.py`): Swin-UNet on the
labeled slices alone (the training list cut to
`patients_to_slices(--labeled_num)`), 224^2 patches, window 7, batch 16,
CE + Dice, validation by the 2D slice predictor every `--val_interval`
steps, the best checkpoint.

    python -m icl_tpu_torch.scripts.train_fully_supervised_swinunet_2D_ACDC \\
        --root_path ../ACDC --exp ACDC/Fully_Supervised --labeled_num 7 \\
        --pretrained_ckpt swin_tiny_patch4_window7_224.pth

The batches are made on a thread of their own (`Prefetcher`). `--cfg`
takes a Swin yaml (the schema of
`configs/swin_tiny_patch4_window7_224_lite.yaml`); its image size follows
`--patch_size`. `--pretrained_ckpt` (or the yaml's MODEL.PRETRAIN_CKPT)
loads an ImageNet Swin-T checkpoint into the encoder and, mirrored, the
decoder (`utils/pretrained.py`). Runs on the CUDA card; `--device cpu`
runs on the CPU. `--precision float32` (the default) runs f32 with TF32
off; `bfloat16` runs the forward under autocast. Every run ends with the
full train state in `model/state_last.pt`. `--scan_steps K` runs the steps
in groups of K, on the card as replays of one captured CUDA graph of the
step; `--dispatch_depth D` keeps up to D groups in flight (`Trainer`).
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.pipeline import Prefetcher, supervised_batches
from icl_tpu_torch.models.swin_config import swin_cli_kwargs
from icl_tpu_torch.scripts.unported import add_dispatch_flags
from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator
from icl_tpu_torch.utils.pretrained import load_pretrained_swinunet


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Fully_Supervised")
    p.add_argument("--model", type=str, default="swinunet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--val_interval", type=int, default=200)
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pretrained_ckpt", type=str, default=None)
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    add_dispatch_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        scan_steps=args.scan_steps, dispatch_depth=args.dispatch_depth,
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, base_lr=args.base_lr,
        patch_size=tuple(args.patch_size), seed=args.seed,
        labeled_num=args.labeled_num, num_tries=args.num_tries,
        val_interval=args.val_interval, precision=args.precision,
        model_kwargs=swin_cli_kwargs(args),
    )
    trainer = Trainer(cfg, device=args.device)
    if args.pretrained_ckpt:
        load_pretrained_swinunet(trainer.model, args.pretrained_ckpt)
    train_ds = ACDCDataset(cfg.root_path, "train",
                           num=patients_to_slices(cfg.root_path, cfg.labeled_num))
    batches = supervised_batches(train_ds, cfg.batch_size, cfg.patch_size, seed=cfg.seed)
    evaluate = acdc_evaluator(ACDCDataset(cfg.root_path, "val_test"), cfg.num_classes,
                              cfg.patch_size, trainer.device)
    with Prefetcher(batches, pin_memory=trainer.device.type == "cuda") as prefetched:
        result = trainer.fit(prefetched, evaluate=evaluate)
    print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
