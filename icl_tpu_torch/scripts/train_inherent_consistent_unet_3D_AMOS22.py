"""ICL 3D U-Net semi-supervised training on AMOS22, 16 classes (counterpart
of `scripts/train_inherent_consistent_unet_3D_AMOS22.py`): U-Net-ICL 3D at
96^3, batch 4 of which 2 labeled, base LR 0.02, loss CE + Dice + aux +
0.1 pse + 10 consistency, recompute on, bf16 autocast, validation every
`--val_interval` steps on validation[:val_num] by the AMOS protocol
(`evaluate_amos_cases`: stride 72, logits stitched, input rounded to
bf16), the best checkpoint with the ICL heads stripped.

    python -m icl_tpu_torch.scripts.train_inherent_consistent_unet_3D_AMOS22 \\
        --root_path ../data/AMOS22 --split_path ../data/AMOS22/dataset_semi_ct.json

The batches are made on a thread of their own (`Prefetcher`). Runs on the
CUDA card; `--device cpu` runs on the CPU. `--precision bfloat16` (the
default) runs the forward under autocast; `float32` runs f32 with TF32
off. `--remat 0` turns the recompute off. `--deterministic` is taken and
has no effect. `--scan_steps K` runs the steps in groups of K, on the card
as replays of one captured CUDA graph of the step; `--dispatch_depth D`
keeps up to D groups in flight (`Trainer`). `--dist_coordinator`, `--num_processes` and `--process_id` run it
data-parallel, one command per rank (as
`train_inherent_consistent_unet_2D` shows).
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.amos import (AMOS_CLASS_NAMES, AMOSDataset, amos_train_batches,
                                     load_decathlon_datalist)
from icl_tpu_torch.parallel.multihost import initialize_from_args, launch_batches
from icl_tpu_torch.scripts.flags import add_dispatch_flags, add_multi_process_flags
from icl_tpu_torch.train.trainer import Trainer, amos_evaluator


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/AMOS22")
    p.add_argument("--split_path", type=str, default="../data/AMOS22/dataset_semi_ct.json")
    p.add_argument("--exp", type=str, default="AMOS22/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="unet_3D_icl")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--max_iterations", type=int, default=60000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=0.02)
    p.add_argument("--patch_size", type=int, nargs=3, default=[96, 96, 96])
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--labeled_num", type=int, default=30)
    p.add_argument("--total_num", type=int, default=200)
    p.add_argument("--val_num", type=int, default=30)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--labeled_bs", type=int, default=2)
    p.add_argument("--precision", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--remat", type=int, default=1)
    p.add_argument("--val_interval", type=int, default=1200)
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
        consis_weight=10.0, pse_weight=0.1, precision=args.precision, remat=bool(args.remat),
    )
    trainer = Trainer(cfg, device=args.device)
    train_ds = AMOSDataset(load_decathlon_datalist(args.split_path, "training"))
    val_ds = AMOSDataset(load_decathlon_datalist(args.split_path, "validation")[:args.val_num],
                         val_mode=True)
    batches = amos_train_batches(train_ds, cfg.labeled_num, args.total_num, cfg.batch_size,
                                 cfg.labeled_bs, cfg.patch_size, seed=cfg.seed)
    evaluate = amos_evaluator(val_ds, cfg.num_classes, cfg.patch_size, trainer.device)
    with launch_batches(batches, cfg.labeled_bs,
                        pin_memory=trainer.device.type == "cuda") as prefetched:
        result = trainer.fit(prefetched, evaluate=evaluate, class_names=AMOS_CLASS_NAMES)
    if rank == 0:
        print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
