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
flag either. `--deterministic` is taken and has no effect. The JAX CLI's
`--input_mode device_bank`, `--state_dtype bfloat16`, `--scan_steps` and
`--dispatch_depth` other than 1 and its multi-process flags are not
ported and are refused.
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.pipeline import Prefetcher, acdc_train_batches
from icl_tpu_torch.scripts.unported import MULTI_PROCESS, parse_args_refusing
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
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fuse_icl_pair", action="store_true")
    p.add_argument("--checkpoint_interval", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return parse_args_refusing(
        p, argv, ("input_mode", "state_dtype", "scan_steps", "dispatch_depth") + MULTI_PROCESS,
        "the port runs one process, one step per dispatch, host batches and an f32 train state")


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, base_lr=args.base_lr,
        patch_size=tuple(args.patch_size), seed=args.seed,
        labeled_num=args.labeled_num, num_tries=args.num_tries,
        labeled_bs=args.labeled_bs, val_interval=args.val_interval,
        precision=args.precision, fuse_icl_pair=args.fuse_icl_pair,
        checkpoint_interval=args.checkpoint_interval,
    )
    trainer = Trainer(cfg, device=args.device)
    train_ds = ACDCDataset(cfg.root_path, "train")
    labeled_slice = patients_to_slices(cfg.root_path, cfg.labeled_num)
    print(f"Total slices: {len(train_ds)}, labeled slices: {labeled_slice}")
    batches = acdc_train_batches(train_ds, labeled_slice, cfg.batch_size, cfg.labeled_bs,
                                 cfg.patch_size, seed=cfg.seed)
    evaluate = acdc_evaluator(ACDCDataset(cfg.root_path, "val_test"), cfg.num_classes,
                              cfg.patch_size, trainer.device)
    with Prefetcher(batches, pin_memory=trainer.device.type == "cuda") as prefetched:
        result = trainer.fit(prefetched, evaluate=evaluate)
    print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
