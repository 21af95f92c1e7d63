"""ICL 2D U-Net semi-supervised training on ACDC (counterpart of
`scripts/train_inherent_consistent_unet_2D.py`): 256^2 patches, batch 16
of which 8 labeled, consistency weight 50, validation by the 2D slice
predictor every `--val_interval` steps, the best checkpoint with the ICL
heads stripped.

    python -m icl_tpu_torch.scripts.train_inherent_consistent_unet_2D \\
        --root_path ../ACDC --exp ACDC/ICL --labeled_num 7

The batches are made on a thread of their own (`Prefetcher`). Runs on the
CUDA card; `--device cpu` runs on the CPU. `--precision float32` (the
default) runs f32 with TF32 off; `bfloat16` runs the forward under
autocast. `--fuse_icl_pair` runs the two labeled-mode `sspa` calls as one.
`--checkpoint_interval N` writes the full train state every N steps
(`model/state_step_*.pt`, the newest 3 kept, `state_last.pt` the newest);
every run ends with `state_last.pt`. A run resumes through
`Trainer.restore_state`, as in the JAX package, whose CLI has no resume
flag either. `--deterministic` is taken and has no effect.

The JAX CLI's fast configuration (`bench.py`'s `icl_unet_acdc_fast`):

    python -m icl_tpu_torch.scripts.train_inherent_consistent_unet_2D --fuse_icl_pair \\
        --precision bfloat16 --state_dtype bfloat16 --input_mode device_bank \\
        --scan_steps 4 --dispatch_depth 2

`--state_dtype bfloat16` stores the parameters and momentum in bf16 and
updates them with the fused stochastic-rounding kernel; `--input_mode
device_bank` holds the training slices on the card, resized once to the
patch, and gathers and augments each batch there, inside the step (the
host sends indices and augment draws); `--scan_steps K` runs the steps in
groups of K, on the card as replays of one captured CUDA graph of the
step; `--dispatch_depth D` keeps up to D groups in flight. The JAX CLI's
multi-process flags are not ported and are refused.
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, two_stream_index_batches
from icl_tpu_torch.data.pipeline import Prefetcher, acdc_train_batches
from icl_tpu_torch.scripts.unported import MULTI_PROCESS, add_dispatch_flags, parse_args_refusing
from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="icl_unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--labeled_bs", type=int, default=8)
    p.add_argument("--val_interval", type=int, default=200)
    p.add_argument("--input_mode", type=str, default="host", choices=["host", "device_bank"])
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--state_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fuse_icl_pair", action="store_true")
    add_dispatch_flags(p)
    p.add_argument("--checkpoint_interval", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return parse_args_refusing(p, argv, MULTI_PROCESS, "the port runs one process")


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, base_lr=args.base_lr,
        patch_size=tuple(args.patch_size), seed=args.seed,
        labeled_num=args.labeled_num, num_tries=args.num_tries,
        labeled_bs=args.labeled_bs, val_interval=args.val_interval,
        precision=args.precision, state_dtype=args.state_dtype,
        fuse_icl_pair=args.fuse_icl_pair, checkpoint_interval=args.checkpoint_interval,
        scan_steps=args.scan_steps, dispatch_depth=args.dispatch_depth,
        device_augment=args.input_mode == "device_bank",
    )
    trainer = Trainer(cfg, device=args.device)
    train_ds = ACDCDataset(cfg.root_path, "train")
    labeled_slice = patients_to_slices(cfg.root_path, cfg.labeled_num)
    print(f"Total slices: {len(train_ds)}, labeled slices: {labeled_slice}")
    evaluate = acdc_evaluator(ACDCDataset(cfg.root_path, "val_test"), cfg.num_classes,
                              cfg.patch_size, trainer.device)
    if args.input_mode == "device_bank":
        image_bank, label_bank = build_acdc_bank(train_ds, int(cfg.patch_size[0]), trainer.device)
        indices = two_stream_index_batches(labeled_slice, len(train_ds), cfg.batch_size,
                                           cfg.labeled_bs, seed=cfg.seed)
        batches = bank_batches(image_bank, label_bank, indices, seed=cfg.seed)
        result = trainer.fit(batches, evaluate=evaluate)
    else:
        batches = acdc_train_batches(train_ds, labeled_slice, cfg.batch_size, cfg.labeled_bs,
                                     cfg.patch_size, seed=cfg.seed)
        with Prefetcher(batches, pin_memory=trainer.device.type == "cuda") as prefetched:
            result = trainer.fit(prefetched, evaluate=evaluate)
    print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
