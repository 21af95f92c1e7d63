"""Swin-UNet-ICL semi-supervised training on ACDC (counterpart of
`scripts/train_inherent_consistent_swinunet_2D.py`): batch 16 of which 8
labeled, consistency weight 50, validation by the 2D slice predictor every
`--val_interval` steps, the best checkpoint with the ICL heads stripped.

    python -m icl_tpu_torch.scripts.train_inherent_consistent_swinunet_2D \\
        --root_path ../ACDC --exp ACDC/ICL --labeled_num 7 \\
        --cfg my_window12.yaml --patch_size 384 384

The batches are made on a thread of their own (`Prefetcher`). `--cfg`
takes a Swin yaml (the schema of
`configs/swin_tiny_patch4_window7_224_lite.yaml`); its image size follows
`--patch_size`. `--pretrained_ckpt` (or the yaml's MODEL.PRETRAIN_CKPT)
loads an ImageNet Swin-T checkpoint into the encoder and, mirrored, the
decoder (`utils/pretrained.py`). Runs on the CUDA card; `--device cpu`
runs on the CPU. `--precision float32` (the default) runs f32 with TF32
off; `bfloat16` runs the forward under autocast. `--deterministic` is
taken and has no effect. The JAX CLI's `--scan_steps` and
`--dispatch_depth` other than 1 and its multi-process flags are not
ported and are refused.
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.pipeline import Prefetcher, acdc_train_batches
from icl_tpu_torch.models.swin_config import swin_cli_kwargs
from icl_tpu_torch.scripts.unported import MULTI_PROCESS, add_dispatch_flags, parse_args_refusing
from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator
from icl_tpu_torch.utils.pretrained import load_pretrained_swinunet


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../ACDC")
    p.add_argument("--exp", type=str, default="ACDC/Inherent_Consistent_Learning")
    p.add_argument("--model", type=str, default="icl_swinunet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--labeled_bs", type=int, default=8)
    p.add_argument("--val_interval", type=int, default=200)
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--pretrained_ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    add_dispatch_flags(p)
    return parse_args_refusing(p, argv, MULTI_PROCESS, "the port runs one process")


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        scan_steps=args.scan_steps, dispatch_depth=args.dispatch_depth,
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, base_lr=args.base_lr,
        patch_size=tuple(args.patch_size), seed=args.seed,
        labeled_num=args.labeled_num, num_tries=args.num_tries,
        labeled_bs=args.labeled_bs, val_interval=args.val_interval,
        precision=args.precision, model_kwargs=swin_cli_kwargs(args),
    )
    trainer = Trainer(cfg, device=args.device)
    if args.pretrained_ckpt:
        load_pretrained_swinunet(trainer.model, args.pretrained_ckpt)
    batches = acdc_train_batches(ACDCDataset(cfg.root_path, "train"),
                                 patients_to_slices(cfg.root_path, cfg.labeled_num), cfg.batch_size,
                                 cfg.labeled_bs, cfg.patch_size, seed=cfg.seed)
    evaluate = acdc_evaluator(ACDCDataset(cfg.root_path, "val_test"), cfg.num_classes,
                              cfg.patch_size, trainer.device)
    with Prefetcher(batches, pin_memory=trainer.device.type == "cuda") as prefetched:
        result = trainer.fit(prefetched, evaluate=evaluate)
    print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
