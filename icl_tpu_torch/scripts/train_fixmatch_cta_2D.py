"""FixMatch + CTAugment semi-supervised training on ACDC (counterpart of
`scripts/train_fixmatch_cta_2D.py`): the plain U-Net at 256^2, batch 16 of
which 8 labeled, weak/strong policies drawn from a live CTAugment learner,
confidence-masked consistency on the unlabeled slices (threshold 0.95,
weight 1), the op rates moved by a probe after every step.

    python -m icl_tpu_torch.scripts.train_fixmatch_cta_2D \\
        --root_path ../ACDC --exp ACDC/FixMatch_CTA --labeled_num 7

The batches are made on the step's thread, as in the JAX CLI: a policy is
drawn when its batch is made, from the rates of that moment. Runs on the
CUDA card, f32 with TF32 off; `--device cpu` runs on the CPU.
The run ends with its train state (`model/state_last.pt`) and the learned
rates (`model/cta_state.json`, the JAX CLI's format);
`--checkpoint_interval N` also saves both every N steps (the rolling
`model/state_step_*.pt`, the newest 3 kept). `--resume`
restores `state_last.pt` if there is one and the persisted rates, and
trains on from the restored step up to `--max_iterations`; the batch
stream starts again from `--seed`, as in the JAX CLI. `--cta_rate_lag 1`
(the default) applies each step's rate update after the next step is
queued; 0 applies it at once. `--model` is `unet` or `swinunet` (the
Swin-UNet, embed 96, window 7; the JAX CLI's command line is `--model
swinunet --patch_size 224 224`, where the image side follows the patch).
"""
from __future__ import annotations

import argparse

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.acdc import ACDCDataset, patients_to_slices
from icl_tpu_torch.data.ctaugment import CTAugment
from icl_tpu_torch.data.pipeline import cta_batches
from icl_tpu_torch.train.cta import CTATrainer
from icl_tpu_torch.utils.checkpoint import latest_checkpoint_step


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../ACDC")
    p.add_argument("--exp", type=str, default="ACDC/FixMatch_CTA")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--labeled_bs", type=int, default=8)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--num_tries", type=str, default="1")
    p.add_argument("--conf_thresh", type=float, default=0.95)
    p.add_argument("--unsup_weight", type=float, default=1.0)
    p.add_argument("--checkpoint_interval", type=int, default=0,
                   help="save the train state and the CTA rates every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore the last train state and the persisted CTA rates first")
    p.add_argument("--cta_rate_lag", type=int, default=1, choices=[0, 1],
                   help="1: apply each rate update after the next step is queued; 0: at once")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = ExperimentConfig(
        root_path=args.root_path, exp=args.exp, model=args.model,
        num_classes=args.num_classes, max_iterations=args.max_iterations,
        batch_size=args.batch_size, labeled_bs=args.labeled_bs,
        base_lr=args.base_lr, patch_size=tuple(args.patch_size),
        labeled_num=args.labeled_num, seed=args.seed, num_tries=args.num_tries,
        checkpoint_interval=args.checkpoint_interval,
    )
    trainer = CTATrainer(cfg, conf_thresh=args.conf_thresh, unsup_weight=args.unsup_weight,
                         device=args.device)
    labeled_count = patients_to_slices(args.root_path, args.labeled_num)
    dataset = ACDCDataset(args.root_path, "train")
    print(f"Total slices: {len(dataset)}, labeled slices: {labeled_count}")
    cta = CTAugment(seed=args.seed)
    if args.resume:
        if latest_checkpoint_step(cfg.snapshot_path) >= 0:
            print(f"Restored the train state at iteration {trainer.restore_state()}")
        if CTATrainer.restore_cta(cfg.snapshot_path, cta):
            print("Restored persisted CTA rates")
    batches = cta_batches(dataset, labeled_count, cfg.batch_size, cfg.labeled_bs, cfg.patch_size,
                          cta, seed=cfg.seed)
    result = trainer.fit(batches, cta, max_steps=cfg.max_iterations,
                         snapshot_path=cfg.snapshot_path,
                         rate_lag=args.cta_rate_lag)
    print("Learned CTA rates:\n" + cta.stats())
    print("Training Finished!")
    return result


if __name__ == "__main__":
    main()
