"""SwinUNETR-ICL semi-supervised training on BraTS2019 (counterpart of
`scripts/train_inherent_consistent_swinunetr_3D_BraTS.py`): batch 4 of
which 2 labeled, 96^3 patches, consistency weight 10, block-level
recompute on, validation by the BraTS sliding window every
`--val_interval` steps, the best checkpoint with the ICL heads stripped.

    python -m icl_tpu_torch.scripts.train_inherent_consistent_swinunetr_3D_BraTS \\
        --root_path ../data/BraTS2019 --exp BraTS2019/ICL --max_iterations 30000

The batches are made on a thread of their own (`Prefetcher`). Runs on the
CUDA card; `--device cpu` runs on the CPU. `--precision float32` runs f32
with TF32 off; `bfloat16` (the default) runs the forward under autocast.
`--use_ssl_pretrained 1` loads the self-supervised SwinViT checkpoint
`--ssl_ckpt` into the encoder (`utils/pretrained.py`); a missing file is
an error. `--scan_steps K` runs the steps in groups of K, on the card as
replays of one captured CUDA graph of the step; `--dispatch_depth D` keeps
up to D groups in flight (`Trainer`). `--dist_coordinator`,
`--num_processes` and `--process_id` run it data-parallel, one command
per rank (as `train_inherent_consistent_unet_2D` shows).
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.brats import BraTS2019Dataset, brats_train_batches
from icl_tpu_torch.parallel.multihost import initialize_from_args, launch_batches
from icl_tpu_torch.scripts.flags import add_dispatch_flags, add_multi_process_flags
from icl_tpu_torch.train.trainer import Trainer, brats_evaluator
from icl_tpu_torch.utils.pretrained import load_pretrained_swinvit


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/BraTS2019")
    p.add_argument("--exp", type=str, default="BraTS2019/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="swinunetr_icl")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--feature_size", type=int, default=48)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--labeled_num", type=int, default=25)
    p.add_argument("--total_num", type=int, default=250)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--labeled_bs", type=int, default=2)
    p.add_argument("--val_interval", type=int, default=200)
    p.add_argument("--precision", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--use_ssl_pretrained", type=int, default=0)
    p.add_argument("--ssl_ckpt", type=str, default="../pretrained_models/model_swinvit.pt")
    p.add_argument("--device", type=str, default="cuda")
    add_dispatch_flags(p)
    add_multi_process_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    rank, _ = initialize_from_args(args.dist_coordinator, args.num_processes, args.process_id,
                                   device=args.device, rows=(args.batch_size, args.labeled_bs))
    cfg = ExperimentConfig(
        scan_steps=args.scan_steps, dispatch_depth=args.dispatch_depth,
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, base_lr=args.base_lr,
        patch_size=tuple(args.patch_size), seed=args.seed,
        labeled_num=args.labeled_num, num_tries=args.num_tries,
        labeled_bs=args.labeled_bs, val_interval=args.val_interval,
        consis_weight=10.0, remat=True, precision=args.precision,
        feature_size=args.feature_size,
    )
    trainer = Trainer(cfg, device=args.device)
    if args.use_ssl_pretrained:
        load_pretrained_swinvit(trainer.model, args.ssl_ckpt)
    batches = brats_train_batches(BraTS2019Dataset(cfg.root_path, "train"), cfg.labeled_num,
                                  args.total_num, cfg.batch_size, cfg.labeled_bs, cfg.patch_size,
                                  seed=cfg.seed)
    evaluate = brats_evaluator(BraTS2019Dataset(cfg.root_path, "val_test"), cfg.num_classes,
                               cfg.patch_size, trainer.device)
    with launch_batches(batches, cfg.labeled_bs,
                        pin_memory=trainer.device.type == "cuda") as prefetched:
        result = trainer.fit(prefetched, evaluate=evaluate, class_names=["WT"])
    if rank == 0:
        print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
