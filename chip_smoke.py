#!/usr/bin/env python3
"""Chip smoke test of icl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. the builds of the window-attention CUDA kernels (forward and
     backward) and of the SR kernel from ops/csrc, one nvcc each, started
     together; each
     kernel instance's registers and spills from the ptxas log, and each
     kernel's warps, shared memory and resident CTAs per SM at the paths'
     window sizes, as the kernel reports them, and their refusal of a
     window that cannot fit;
  3. the forward kernel against its plain PyTorch version at the four
     shapes of one SwinUNETR fs48 sw_batch-4 forward at 96^3, f32 and
     bf16, and bitwise equal across two runs;
  4. times at those shapes: the kernel, the plain version, and
     F.scaled_dot_product_attention as the one PyTorch call that computes
     the same function, beside the kernel's bound and its time before its
     tensor-core redesign (a constant from PERF.md);
  5. BraTS sliding-window inference with SwinUNETR fs48 (1 channel, 2
     classes, seeded init) on a seeded 160x160x128 volume, 96^3 patches,
     stride 64, sw_batch 4: 8 patches in 2 forwards; the kernel launches
     are counted and must be 16 (5 no-mask + 3 region per forward);
  6. one sw_batch forward's probabilities against the same weights with
     the plain attention;
  7. the backward kernel against its plain version at the four attention
     shapes of one SwinUNETR-ICL training pass (batch 2 at 96^3), in both
     mask modes where the stage shifts, f32 and bf16, and bitwise equal
     across two runs;
  8. times at those shapes: the backward kernel, the plain backward, and
     the backward of F.scaled_dot_product_attention (q, k, v and the mask),
     beside the bound and the kernel's time before its tensor-core
     redesign (a constant from PERF.md);
  9. SwinUNETR-ICL training: fs48 at 96^3, batch 4 (2 labeled), f32 with
     TF32 off, recompute on, through Trainer.fit for 3 steps on seeded
     in-memory 128^3 cases, with a validation at step 3 on one held-out
     case; s/step after the warm-up step, peak memory, every loss term,
     and the kernel launches per step (asserted: 16 backward, 10 no-mask +
     6 region; 32 forward, the 16 of the two passes and their recompute);
     then one step under bfloat16 autocast;
 10. one training step through the kernels against the same step with the
     plain attention (same weights and batch, f32, drop path off): every
     loss term, and the updated bias tables and qkv weights of stages 1
     and 4;
 11. train -> eval: the stripped best checkpoint loads strictly through
     the eval CLI's loader and gives the trainer's validation dice;
 12. the dense-mask (MASK) and no-mask forward kernels at head dim 32
     against their plain versions at the attention shapes of one
     Swin-UNet 2D backbone pass at 384^2, window 12, batch 8, at the
     reference's 224^2 / window-7 stage 1 and at a 2 x 2 window, with the
     shift mask and a random dense mask, f32 and bf16, bitwise equal
     across two runs; f32 times beside the bound, the plain version, SDPA
     and the time before the redesign;
 13. the backward kernel in both modes at head dim 32 at the same shapes,
     both masks, f32 and bf16, bitwise equal across two runs;
     f32 times beside the bound, the plain backward, SDPA's backward and
     the time before the redesign;
 14. Swin-UNet-ICL training on ACDC, the main path of this slice: embed
     96, depths 2-2-2-2, heads 3-6-12-24, 384^2, window 12, 4 classes,
     batch 16 (8 labeled), consistency weight 50, f32 with TF32 off, no
     recompute, through Trainer.fit for 3 steps on seeded in-memory
     256^2 slices, with a validation at step 3 on two seeded volumes;
     s/step after the warm-up step, the host's batch time, the validation
     time, peak memory, every loss term, and the kernel launches (asserted
     per step: 28 forward and 28 backward, each 16 no-mask + 12 mask; per
     validation chunk 14 forward, 8 + 6);
 15. one 2D training step through the kernels against the same step with
     the plain attention, beside a control step, as in 10;
 16. 2D train -> eval: the stripped best checkpoint loads strictly
     through the 2D eval CLI's loader and gives the trainer's validation
     dice;
 17. U-Net-ICL training on ACDC, the main path of this slice and the JAX
     package's default model: U-Net features (16, 32, 64, 128, 256),
     dropout (0.05, 0.1, 0.2, 0.3, 0.5), ICL heads on (128, 64, 32)
     channels, heads (8, 4, 2), resolutions (32, 64, 128) (`mlp2` 16384^2
     at the finest), 256^2, 4 classes, batch 16 (8 labeled), consistency
     weight 50, f32 with TF32 off, through Trainer.fit for 3 steps on
     phase 14's slices made on a `Prefetcher` thread, with a validation
     at step 3 on its two volumes; s/step after the warm-up step, the
     step thread's wait for each batch, the validation time, the time to
     build the model, peak memory, every loss term, and the
     window-attention launches (asserted: none);
 18. one U-Net-ICL step at 64^2 on the card against the same step on the
     CPU (same weights and batch, dropout and drop path off), beside a
     control step, the rule of 10 over every parameter;
 19. one full-width U-Net-ICL step with the two `sspa` calls fused
     against the two-call step on the card, in f64, the rule of 10;
 20. U-Net train -> eval: the stripped best checkpoint loads strictly into
     UNet through the 2D eval CLI's loader and gives the trainer's
     validation dice;
 21. U-Net-ICL 3D training on BraTS, the main path of this slice, at the
     JAX 3D U-Net CLI's defaults: filters (16, 32, 64, 128, 256), ICL heads
     on (256, 128, 64) channels, heads (16, 8, 4), resolutions (6, 12, 24)
     (`mlp2` 13824^2 at the finest), 96^3, batch 4 (2 labeled), 2 classes,
     consistency weight 10, f32 with TF32 off, through Trainer.fit for 3
     steps on phase 9's 128^3 cases made on a `Prefetcher` thread, with a
     validation at step 3 on the held-out case; s/step after the warm-up
     step, the step thread's wait for each batch, the validation time, the
     time to build the model, its parameters, peak memory, every loss
     term, the window-attention launches (asserted: none); then one step
     under bfloat16 autocast;
 22. one U-Net-ICL 3D step at 32^3 on the card against the same step on
     the CPU (same weights and batch, dropout and drop path off), beside a
     control step, the rule of 18;
 23. two steps of the supervised U-Net 3D on the BraTS cases through
     Trainer.fit (no window attention, asserted);
 24. U-Net 3D train -> eval: the stripped best checkpoint of 21 loads
     strictly into UNet3D through test_3D_BraTS's loader (`--model
     unet_3D_icl`) and gives the trainer's validation dice;
 25. AMOS22 through the JAX AMOS CLI's own defaults (`main` of the port's
     CLI): a seeded synthetic NIfTI tree (4 training cases and 1
     validation case of (96, 96, 72) voxels at spacing (2, 2, 3)),
     U-Net-ICL 3D, 16 classes, bf16 autocast, recompute on, 3 steps and a
     validation by `evaluate_amos_cases`; s/step, peak memory, every loss
     term, the validation time, the window-attention launches (none);
 26. the supervised AMOS CLI for 2 steps (loss 0.5 (CE + Dice));
 27. AMOS train -> eval: test_3D_AMOS on the stripped best checkpoint of
     25 gives the trainer's validation dice;
 28. both kernels at the shapes of the fully supervised Swin paths,
     against their plain versions and bitwise repeatable, timed beside
     the bound, the plain version and SDPA: Swin-UNet at 224^2 / window
     7, batch 16, f32, stages 1-4 (N = 49; with the shift mask and
     without); SwinUNETR at batch 4 in bf16, stages 1-4 (stage 1
     [1372, 3, 343, 16]; with region ids and without);
 29. the supervised 2D U-Net CLI's `main` at its defaults (256^2, batch
     16, f32) on phase 14's slices and volumes in memory, 3 steps and a
     validation, no window attention (asserted); `test_2D_ACDC.main
     --model unet` on its best checkpoint gives the validation dice;
 30. the supervised Swin-UNet CLI's `main` at its defaults (224^2,
     window 7, batch 16, f32) from a synthetic ImageNet-layout Swin-T
     checkpoint (a seeded model's encoder, a head, one key of the wrong
     shape, which is dropped with its decoder mirror), 3 steps and a
     validation, the launches per step asserted (8 no-mask + 6 mask,
     forward and backward; per validation chunk 8 + 6 forward); one step
     through the kernels against the plain attention by the rule of 15;
     `test_2D_ACDC.main --model swinunet` gives the validation dice;
 31. the supervised SwinUNETR CLI's `main` at its defaults (fs48, 96^3,
     batch 4, bf16, recompute on) from a synthetic SSL SwinViT checkpoint
     in the reference layout (every encoder parameter loaded), 3 steps
     and a validation on phase 9's cases, the launches per step asserted
     (forward 10 no-mask + 6 region with the recompute, backward 5 + 3);
     `test_3D_BraTS.main --model swinunetr` gives the validation dice;
 32. resume on U-Net-ICL 2D at full width: 4 steps against 2, a save, a
     fresh Trainer's `restore_state` (equal to the saved state bit for
     bit: parameters, buffers, momentum, count, iteration, RNG states)
     and 2 more on the same batches, under cuDNN's deterministic
     algorithms: bit for bit, as a repeat of the 4 steps is; the seconds
     of the rolling save, the restore and the final save;
 33. FixMatch-CTA through its CLI's `main` at the JAX CLI's defaults (the
     U-Net, 256^2, batch 16 of which 8 labeled, 4 classes, threshold 0.95,
     unsupervised weight 1, f32 with TF32 off) on phase 14's slices in
     memory, the first 16 labeled: 4 steps with --checkpoint_interval 2
     --cta_rate_lag 1, then 2 steps with --cta_rate_lag 0 under an --exp
     of their own; s/step after the warm-up step, peak memory, every loss
     term, the mask ratio and probe proximity per step, the rate bins that
     moved (asserted: some), the window-attention launches (asserted:
     none); the host seconds of one cta_batches batch made alone (the CLI
     makes its batches inline), and of the step alone;
 34. one FixMatch-CTA step at 64^2 on the card against the same step on
     the CPU (same weights and batch, dropout off, the threshold in a gap
     of the confidences near their median, so that the mask is neither
     empty nor full and the same on all, asserted): in f64 by the rule
     of 18 beside a control step; in f32 against the CPU's f64 step,
     with the CPU's own f32 step as the witness of f32 rounding; the fused
     probe proximity against a separate probe forward on the card;
 35. resume: a fresh CTATrainer restores 33's rate-lag-1 save at step 4
     (state_last, bit for bit; cta_state.json, the rates equal), then the
     CLI's --resume takes steps 5 and 6, saves step_00000006 and ends
     with state_last;
 36. the bf16 stochastic-rounding SGD kernel (built in phase 2 beside the
     window-attention kernels) against its plain version, bit for bit,
     and bitwise across two runs, at the flagship's largest leaf (`mlp2`,
     16384^2), a small leaf, a ragged length and an unaligned address;
     over the flagship's 300 leaves (1.15 B parameters): its time per call
     and on the device alone beside the 3.4 ms bound, the plain version,
     torch.optim.SGD(fused=True) on the same bf16 tensors and the f32
     PolySGD step on an f32 state; then the card's kernel tests, both files
     in one pytest without tests/conftest.py;
 37. the flagship's fast configuration through its CLI's `main` (bf16
     autocast, a bf16 train state, the fused sspa pair, the device bank,
     groups of 4 graph replays, 2 in flight) on phase 14's slices in
     memory: 8 steps, a validation at 8, a checkpoint every 4; peak
     memory, the state's bytes, every loss term, the SR launches (asserted:
     300 for the eager first step and 300 recorded by the capture, which
     every one of the 7 replays runs), no window attention (asserted);
 38. graph replay against eager steps from one state (cuDNN's deterministic
     algorithms): the flagship's fast configuration and the supervised
     Swin-UNet (224^2, window 7, batch 16, f32; the launches of the graph's
     first step asserted: 8 no-mask + 6 mask, forward and backward, for the
     eager step and again for the capture), 4 replays against 4 eager
     steps bit for bit (parameters, buffers, momentum, metrics), an eager
     repeat beside them; s/step eager and replayed for both and for the
     AMOS bf16 ICL step; whether the backward of F.interpolate's bilinear
     upsample repeats bitwise on the card (the port's linear resizes are
     matmuls for that reason);
 39. under cuDNN's deterministic algorithms, `fit` of the supervised
     Swin-UNet in groups of 2 at dispatch_depth 2 against 1 (parameters bit
     for bit, log.txt's loss lines equal), and the bf16 train state resumed
     from a step-4 save, 4 + 4 steps against 8 bit for bit, on the
     supervised Swin-UNet and on the flagship's fast configuration;
 40. the device augment (`augment_batch`) on the card against the CPU for
     every angle in [-20, 20), every rot90/flip branch and the identity, at
     256^2 and zoomed to 224^2: 0 differing pixels; one flagship batch's
     time;
every `fit` ends with its full train state, which each phase deletes
after its run; then a `kernels` JSON line (the six window-attention
entries and `sgd_bf16`), the card line, and the result line. Exits
non-zero without a result when CUDA is absent.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

F32_ATOL = 1e-5  # f32 rounding of 343-term sums in another order; 2e-6 seen on an H100
# bf16 inputs, f32 math in both versions, one bf16 rounding of the output:
# at most one bf16 ulp apart, i.e. 2^-7 relative
BF16_ATOL, BF16_RTOL = 1e-3, 1e-2
PROBS_ATOL = 1e-4  # end-to-end probabilities, f32 with TF32 off
# The card's fastest f32-accurate rate, for the bound of both kernels: TF32
# on the tensor cores (H100 SXM, 495 TFLOP/s dense) over the three MMAs of a
# 3xTF32 product, above the 67 TFLOP/s of f32 outside the tensor cores.
F32_ACCURATE_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
# Backward kernel against the plain backward, each grad's max error over
# its reference's largest magnitude. f32: sums of 343 terms in another
# order, __expf, and dbias summing up to 686 windows in another order
# (9.7e-7 seen on an H100). bf16: dq, dk, dv are rounded once to bf16 from
# f32 math in both versions, so within one bf16 ulp (2^-7) of the value;
# dbias stays f32.
BWD_F32_RTOL = 1e-5
BWD_BF16_RTOL = 8e-3
# One training step through the kernels against the same step with the
# plain attention (f32, TF32 off). Loss terms: relative, 1e-4 (f32 sums of
# the forward in another order; 1.3e-7 seen on an H100). Each updated
# tensor: within 5e-3 of its largest update plus two f32 ulps of its
# largest weight. The two forwards differ only by f32 rounding, and the
# step amplifies that in the grads reaching the attention parameters to
# about 1e-3 of their largest update on an H100, whichever way the
# difference arises: the control step (input scaled by 1 + 1e-7) moves
# them as far. Updates of ~1e-7 on weights of ~0.04
# round to single ulps, hence the ulp term.
STEP_LOSS_RTOL = 1e-4
STEP_UPDATE_RTOL = 5e-3

DEVICE = "cuda"
# the main path: SwinUNETR fs48, sw_batch 4, 96^3 patches, stride 64 on a
# 160x160x128 volume (8 patches, 2 forwards)
FEATURE_SIZE, PATCH, STRIDE, SW_BATCH, VOLUME = 48, 96, 64, 4, (160, 160, 128)
# The attention calls of one such forward: per stage the padded dims,
# window, shift, heads; stages 1-3 shift (region ids), stage 4 (6^3) does not.
STAGES = [
    ("stage1", SW_BATCH, (49, 49, 49), (7, 7, 7), (3, 3, 3), 3),
    ("stage2", SW_BATCH, (28, 28, 28), (7, 7, 7), (3, 3, 3), 6),
    ("stage3", SW_BATCH, (14, 14, 14), (7, 7, 7), (3, 3, 3), 12),
    ("stage4", SW_BATCH, (6, 6, 6), (6, 6, 6), (0, 0, 0), 24),
]
HEAD_DIM = 16
# launches of each variant per forward at each stage (block 0 no-mask,
# block 1 region where the stage shifts)
PER_FORWARD = {"none": {"stage1": 1, "stage2": 1, "stage3": 1, "stage4": 2},
               "region": {"stage1": 1, "stage2": 1, "stage3": 1}}
REPLACES = {"none": "icl_tpu/ops/pallas/window_attention.py:44",
            "region": "icl_tpu/ops/pallas/window_attention.py:60",
            "mask": "icl_tpu/ops/pallas/window_attention.py:28"}
BWD_REPLACES = "icl_tpu/ops/pallas/window_attention.py:290"
# The forward kernel before its tensor-core redesign: f32 ms per launch by
# (stage, mode), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel
# table, the column before the redesign). The 3D stages 2-4 were not
# written down one by one.
FWD_BEFORE_MS = {("stage1", "none"): 2.944, ("stage1", "region"): 3.006}
FWD2D_BEFORE_MS = {("stage1", "none"): 0.559, ("stage2", "none"): 0.291, ("stage3", "none"): 0.156,
                   ("stage4", "none"): 0.101, ("ref224_stage1", "none"): 0.147, ("stage1", "mask"): 0.797,
                   ("stage2", "mask"): 0.410, ("stage3", "mask"): 0.265, ("ref224_stage1", "mask"): 0.190}
# The backward kernel before its tensor-core redesign: f32 ms per launch by
# (stage, mode), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel
# table, the earlier kernel's column). The 3D stages 2-4 and the extra 2D
# windows were not written down one by one.
BWD_BEFORE_MS = {("stage1", "none"): 5.178, ("stage1", "region"): 5.353}
BWD2D_BEFORE_MS = {("stage1", "none"): 1.849, ("stage2", "none"): 0.948, ("stage3", "none"): 0.651,
                   ("stage4", "none"): 0.339, ("stage1", "mask"): 1.961, ("stage2", "mask"): 0.949,
                   ("stage3", "mask"): 0.631}

# The training path: SwinUNETR-ICL fs48 at 96^3, batch 4 of which 2
# labeled; each backbone pass runs batch 2, so the attention shapes are
# those of STAGES at batch 2.
TRAIN_BATCH, LABELED_BS, TRAIN_STEPS, CASE_SIZE = 4, 2, 3, 128
# kernel launches per training step: two backbone passes, each with
# PER_FORWARD's calls, and recompute runs every Swin block's forward again
BWD_PER_STEP_BY_STAGE = {m: {st: 2 * n for st, n in PER_FORWARD[m].items()} for m in ("none", "region")}
BWD_PER_STEP = {m: sum(w.values()) for m, w in BWD_PER_STEP_BY_STAGE.items()}
FWD_PER_STEP = {m: 2 * n for m, n in BWD_PER_STEP.items()}

# This slice: Swin-UNet-ICL 2D, Swin-T lite widths (embed 96, depths
# 2-2-2-2, heads 3-6-12-24: head dim 32) at 384^2 with window 12 (N = 144),
# the window/size pair of Swin's public 384-px configs; batch 16 of which
# 8 labeled, so each backbone pass runs batch 8.
IMG_2D, WINDOW_2D, CLASSES_2D, BATCH_2D, LABELED_2D, HEAD_DIM_2D = 384, 12, 4, 16, 8, 32
SLICE_SIZE_2D, SLICES_2D, LABELED_SLICES_2D, VOLUMES_2D, VOL_DEPTH_2D = 256, 32, 16, 2, 10
# The attention calls of one backbone pass at batch 8: per shape the grid
# side, the window, the heads and the launches of each mode. Stages 1-3
# shift in their odd block, in the encoder and in the decoder stage of the
# same size (layers_up.3, .2, .1); stage 4 (12^2) is one unshifted window.
STAGES_2D = [
    ("stage1", 96, 12, 3, {"none": 2, "mask": 2}),
    ("stage2", 48, 12, 6, {"none": 2, "mask": 2}),
    ("stage3", 24, 12, 12, {"none": 2, "mask": 2}),
    ("stage4", 12, 12, 24, {"none": 2}),
]
# stage 1 of the reference's 224^2 / window-7 configuration (N = 49), and
# a window of 2 x 2 tokens (N = 4, fewer keys than a lane's first tile of the
# backward holds: a stage of 2 x 2 tokens shrinks the window to 2), shifted
# by 1 on a 4 x 4 grid for the mask
REF_STAGE_2D = ("ref224_stage1", 56, 7, 3, {"none": 2, "mask": 2})
TINY_STAGE_2D = ("window2", 4, 2, 24, {"none": 2, "mask": 2})
PER_FORWARD_2D = {m: sum(st[4].get(m, 0) for st in STAGES_2D) for m in ("none", "mask")}
PER_STEP_2D = {m: 2 * n for m, n in PER_FORWARD_2D.items()}  # two passes, no recompute
# This slice: U-Net-ICL 2D at the JAX U-Net CLI's defaults (256^2, batch 16
# of which 8 labeled, 4 classes) on phase 14's slices and volumes; its step
# on the card against the CPU at 64^2.
IMG_UNET, IMG_UNET_CPU = 256, 64
# This slice: the 3D U-Net family at the JAX 3D U-Net CLIs' defaults:
# U-Net-ICL 3D, filters (16, 32, 64, 128, 256), ICL heads on (256, 128, 64)
# channels, heads (16, 8, 4), resolutions (6, 12, 24) (`mlp2` 13824^2 at the
# finest), 96^3, batch 4 of which 2 labeled, consistency weight 10: on
# BraTS (phase 9's 128^3 cases, 2 classes, f32) and on AMOS22 (a seeded
# NIfTI tree, 16 classes, pse weight 0.1, base LR 0.02, bf16 autocast,
# recompute on); its step on the card against the CPU at 32^3. The AMOS
# tree holds 4 training cases (the supervised CLI's batch of 4 needs 4
# labeled ones) and 1 validation case, (96, 96, 72) voxels at spacing
# (2, 2, 3), about 127 x 127 x 107 at the protocol's spacing.
UNET3D_CPU = 32
AMOS_CASES, AMOS_SHAPE, AMOS_SPACING = 5, (96, 96, 72), (2.0, 2.0, 3.0)
# This slice: the fully supervised baselines at the JAX supervised CLIs'
# defaults, each through its CLI's `main` on in-memory data (the card's
# machine has no h5py): the 2D U-Net (256^2, batch 16, f32), Swin-UNet
# (embed 96, 224^2, window 7, batch 16, f32: one backbone pass at batch 16,
# N = 49) and SwinUNETR (fs48, 96^3, batch 4, bf16 autocast, recompute on:
# one pass at batch 4, so stage 1 runs [1372, 3, 343, 16]); then a resume of
# the flagship U-Net-ICL 2D at full width.
IMG_SWIN_SUP, WINDOW_SWIN_SUP, BATCH_SWIN_SUP = 224, 7, 16
# The attention calls of one Swin-UNet pass at 224^2 / window 7: per shape
# the grid side, the window, the heads and the launches of each mode.
# Stages 1-3 shift in their odd block, in the encoder and in the decoder
# stage of the same size; stage 4 (7^2 tokens) is one unshifted window.
STAGES_SWIN_SUP = [
    ("w7_stage1", 56, 7, 3, {"none": 2, "mask": 2}),
    ("w7_stage2", 28, 7, 6, {"none": 2, "mask": 2}),
    ("w7_stage3", 14, 7, 12, {"none": 2, "mask": 2}),
    ("w7_stage4", 7, 7, 24, {"none": 2}),
]
PER_FORWARD_SWIN_SUP = {m: sum(st[4].get(m, 0) for st in STAGES_SWIN_SUP) for m in ("none", "mask")}
# the SwinUNETR supervised step: one pass at batch 4 and its recompute
SUP_3D_FWD_PER_STEP = {m: 2 * sum(PER_FORWARD[m].values()) for m in ("none", "region")}
SUP_3D_BWD_PER_STEP = {m: sum(PER_FORWARD[m].values()) for m in ("none", "region")}
RESUME_STEPS = 4
# This slice: FixMatch-CTA at the JAX CLI's defaults (the U-Net, 256^2, batch
# 16 of which 8 labeled, 4 classes, threshold 0.95, unsupervised weight 1)
# on phase 14's slices; its step at 64^2 on the card against the CPU; the
# resume of its rate-lag-1 run.
CTA_EXP, CTA_EXP_LAG0 = "ACDC_chip_smoke/FixMatch_CTA", "ACDC_chip_smoke/FixMatch_CTA_lag0"
CTA_STEPS, CTA_HOST_BATCHES, CTA_TIMED_STEPS = 4, 5, 3
# the fused probe against a separate forward of the same weights: one f32
# forward in another call
CTA_PROXIMITY_ATOL = 1e-5
# The f32 FixMatch step against the f64 one: the CPU's own f32 step, the
# witness, puts decoder.up1.conv.conv_conv.4.weight at 1.8x the fixed
# allowance (f32 cancellation in the grads of the convs that feed a
# train-mode BatchNorm), where the card's f32 step stays within it on an
# H100; a tensor may part from the f64 step by the fixed allowance or by
# this many times the witness's distance, whichever is larger.
STEP_WITNESS_FACTOR = 2.0
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPERIMENTS = os.path.join(ROOT, "build", "chip_smoke", "experiments")
AMOS_ROOT = os.path.join(ROOT, "build", "chip_smoke", "amos")  # ../experiments is EXPERIMENTS
SUP_ROOT = os.path.join(ROOT, "build", "chip_smoke", "acdc")  # ../experiments is EXPERIMENTS


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# Set by `bench_kernels.py --device-time`: cuda_ms then queues the timed
# launches behind a GPU sleep (~25 ms at the H100's clock), so that the
# events time the device's work alone, not the host's time to issue each
# launch, which sets the time of the smallest shapes.
QUEUE_BEHIND_SLEEP = False
SLEEP_CYCLES = 50_000_000


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if QUEUE_BEHIND_SLEEP:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_inputs(torch, stage, dtype, gen):
    from icl_tpu_torch.models.swinunetr import window_region_ids_3d

    name, batch, padded, ws, shift, heads = stage
    nW = (padded[0] // ws[0]) * (padded[1] // ws[1]) * (padded[2] // ws[2])
    N = ws[0] * ws[1] * ws[2]
    B = batch * nW
    q, k, v = (torch.randn(B, heads, N, HEAD_DIM, device=DEVICE, generator=gen).to(dtype)
               for _ in range(3))
    bias = torch.randn(heads, N, N, device=DEVICE, generator=gen)
    ids = window_region_ids_3d(padded, ws, shift)
    return q, k, v, bias, None if ids is None else torch.from_numpy(ids).to(DEVICE)


def bound(B, H, N, D, mask_floats=0, backward=False, elem_bytes=4, flops_rate=F32_ACCURATE_FLOPS):
    """(ms at the type's rate, ms at the memory rate). Forward: two N x N x D
    products per (window, head); q, k, v read and out written once, bias
    read once. Backward: five products; q, k, v, dO read and dq, dk, dv
    written once, bias read and dbias written once. The region ids [nW, N]
    or the dense mask [nW, N, N] (`mask_floats` values) read once. q, k, v
    and their grads take `elem_bytes` each (2 in bf16), the rest 4; the
    products run at `flops_rate` (BF16_FLOPS in bf16)."""
    products, tensors, bias_arrays = (5, 7, 2) if backward else (2, 4, 1)
    flops = 2 * products * B * H * N * N * D
    nbytes = tensors * B * H * N * D * elem_bytes + (bias_arrays * H * N * N + mask_floats) * 4
    return flops / flops_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def ptxas_usage(log: str, kernel: str) -> dict:
    """{"<type> D<d> <mode>": [registers, spill stores in bytes]} of each
    instance of `kernel`, from the `-Xptxas -v` build log."""
    import re

    out, name = {}, None
    modes = ("none", "region", "mask")
    for line in log.splitlines():
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d)E", line)
        if m:
            name = f"{'f32' if m[1] == 'f' else 'bf16'} D{m[2]} {modes[int(m[3])]}"
        elif name and "spill stores" in line:
            out[name] = [None, int(re.search(r"(\d+) bytes spill stores", line)[1])]
        elif name and "registers" in line:
            out.setdefault(name, [None, 0])[0] = int(re.search(r"Used (\d+) registers", line)[1])
            name = None
    return out


def bound_fields(flop_ms, byte_ms) -> dict:
    return {"flop_ms": flop_ms, "byte_ms": byte_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def sdpa_backward_ms(torch, F, q, k, v, bias, mask, g, scale) -> float:
    """The backward of F.scaled_dot_product_attention with attn_mask =
    bias (+ the dense mask [nW, N, N]), in q's dtype, for q, k, v and the
    bias, timed on a retained graph."""
    B, H, N, D = q.shape
    nW = mask.shape[0] if mask is not None else B
    shape = (B // nW, nW, H, N, D) if mask is not None else (B, H, N, D)
    qs, ks, vs = (t.detach().view(shape).requires_grad_(True) for t in (q, k, v))
    mask_leaf = bias.detach().to(q.dtype).clone().requires_grad_(True)
    attn = mask_leaf if mask is None else mask_leaf[None] + mask[:, None].to(q.dtype)
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn, scale=scale)
    gout = g.view(shape)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs, mask_leaf), gout, retain_graph=True))


def phase_kernel_3d(torch, F, wa) -> list[dict]:
    """3 + 4: the forward kernel against its plain version at the shapes of
    one SwinUNETR inference forward, f32 and bf16, bitwise-repeatable; f32
    times beside the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    per_shape = []
    for stage in STAGES:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, stage, dtype, gen)
                ids = ids if mode == "region" else None
                scale = HEAD_DIM ** -0.5
                got = wa.window_attention(q, k, v, bias, ids, scale=scale)
                again = wa.window_attention(q, k, v, bias, ids, scale=scale)
                torch.cuda.synchronize()
                want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
                err = (got.float() - want.float()).abs()
                max_err = float(err.max())
                if dtype == torch.float32:
                    ok = max_err <= F32_ATOL
                else:
                    ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                row = {"stage": name, "mode": mode, "dtype": str(dtype).split(".")[-1],
                       "shape": list(q.shape), "nW": ids.shape[0] if ids is not None else None,
                       "max_abs_err": max_err, "bitwise_repeat": torch.equal(got, again)}
                if not ok or not row["bitwise_repeat"] or not torch.isfinite(got).all():
                    fail(f"kernel disagrees with plain or is not repeatable: {row}")
                if dtype == torch.float32:
                    B, H, N, D = q.shape
                    nW = ids.shape[0] if ids is not None else B
                    if ids is None:
                        mask = bias
                        qs, ks, vs = q, k, v
                    else:
                        mask = bias[None] + wa.mask_from_region_ids(ids)[:, None]  # [nW, H, N, N]
                        qs, ks, vs = (t.view(B // nW, nW, H, N, D) for t in (q, k, v))
                    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
                    lib_err = float((lib_out.reshape(q.shape) - want).abs().max())
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask, scale=scale)),
                        library_max_abs_err=lib_err,
                        before_ms=FWD_BEFORE_MS.get((name, mode)),
                        **bound_fields(*bound(B, H, N, D, ids.numel() if ids is not None else 0)),
                    )
                    del mask, lib_out
                per_shape.append(row)
                print(f"[kernel] {json.dumps(row)}", flush=True)
                del q, k, v, bias, got, again, want, err
    torch.cuda.empty_cache()
    return per_shape


def phase_backward_kernel(torch, F, wa) -> list[dict]:
    """7 + 8: the backward kernel against its plain version at the training
    shapes, f32 and bf16, bitwise-repeatable; f32 times beside the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for stage in STAGES:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, ids = stage_inputs(torch, (name, LABELED_BS) + stage[2:], dtype, gen)
                ids = ids if mode == "region" else None
                g = torch.randn(q.shape, device=DEVICE, generator=gen).to(dtype)
                scale = HEAD_DIM ** -0.5
                got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
                again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
                torch.cuda.synchronize()
                want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale)
                names = ("dq", "dk", "dv", "dbias")
                errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
                tols = {n: BWD_F32_RTOL if dtype == torch.float32 or n == "dbias" else BWD_BF16_RTOL
                        for n in names}
                row = {"stage": name, "mode": mode, "dtype": str(dtype).split(".")[-1],
                       "shape": list(q.shape), "nW": ids.shape[0] if ids is not None else None,
                       "rel_err": errs, "tolerance": tols,
                       "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                          for a, b in zip(got, want)),
                       "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again))}
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                if not finite or not row["bitwise_repeat"] or any(errs[n] > tols[n] for n in names):
                    fail(f"backward kernel disagrees with plain or is not repeatable: {row}")
                if dtype == torch.float32:
                    B, H, N, D = q.shape
                    dense = wa.mask_from_region_ids(ids) if ids is not None else None
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                            q, k, v, bias, ids, g, scale=scale), reps=3),
                        library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                        before_ms=BWD_BEFORE_MS.get((name, mode)),
                        **bound_fields(*bound(B, H, N, D, ids.numel() if ids is not None else 0,
                                              backward=True)),
                    )
                rows.append(row)
                print(f"[bwd] {json.dumps(row)}", flush=True)
                del q, k, v, g, bias, got, again, want
                torch.cuda.empty_cache()
    return rows


def train_config(precision: str, max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(
        root_path="in-memory", exp="BraTS_chip_smoke/ICL", model="swinunetr_icl", num_classes=2,
        max_iterations=max_iterations, batch_size=TRAIN_BATCH, labeled_bs=LABELED_BS,
        base_lr=0.01, patch_size=(PATCH,) * 3, seed=1337, labeled_num=2, num_tries=tries,
        consis_weight=10.0, val_interval=val_interval, log_interval=1, precision=precision,
        remat=True, feature_size=FEATURE_SIZE, experiments_dir=EXPERIMENTS)


def phase_training(torch, wa, cases, held_out) -> dict:
    """9: Trainer.fit at full width, then one bf16 step."""
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, brats_evaluator

    cfg = train_config("float32", TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                  seed=cfg.seed)
    validate = brats_evaluator(held_out, 2, cfg.patch_size, trainer.device)
    per_steps = {}

    def evaluate(model):
        # the steps' launches, before the validation's forward launches
        per_steps["fwd"] = dict(wa.window_attention.launches_by_mode)
        per_steps["bwd"] = dict(wa.window_attention_bwd.launches_by_mode)
        return validate(model)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    result = trainer.fit(batches, evaluate=evaluate, class_names=["WT"])
    torch.cuda.synchronize()
    drop_states(result)
    path = {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    steps_launches = {kind: {m: n / TRAIN_STEPS for m, n in c.items()} for kind, c in per_steps.items()}
    print(f"[train] SwinUNETR-ICL fs{FEATURE_SIZE}, {n_params} params, built in {build_s:.1f} s; "
          f"{PATCH}^3 batch {TRAIN_BATCH} ({LABELED_BS} labeled), f32, TF32 off, recompute on: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step {steps_launches}; "
          f"whole run with validation {path}", flush=True)
    for r in log:
        print(f"[train] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[train] validation at step {val['iteration']} on one held-out {CASE_SIZE}^3 case: "
          f"mean dice {val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint "
          f"{result['best_path']}", flush=True)
    want = {"fwd": FWD_PER_STEP, "bwd": BWD_PER_STEP}
    for kind in ("fwd", "bwd"):
        if per_steps[kind] != {**{m: TRAIN_STEPS * n for m, n in want[kind].items()}, "mask": 0}:
            fail(f"{kind} launches over {TRAIN_STEPS} steps: {per_steps[kind]}, expected "
                 f"{want[kind]} per step")
    if result["best_path"] is None:
        fail(f"validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    cfg16 = train_config("bfloat16", 1, 0, "bfloat16")
    trainer = Trainer(cfg16, device=DEVICE)
    result16 = trainer.fit(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS,
                                               cfg16.patch_size, seed=cfg16.seed))
    drop_states(result16)
    log16 = result16["log"]
    print("[train] one bfloat16 autocast step: "
          + " ".join(f"{k} {log16[0][k]:.6f}" for k in METRIC_KEYS), flush=True)
    if not all(math.isfinite(log16[0][k]) for k in METRIC_KEYS):
        fail("non-finite loss under bfloat16")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"], "log": log}


def phase_step_parity(torch, wa, cases) -> None:
    """10: one SwinUNETR-ICL step through the kernels against the plain
    attention (stages 1 and 4 watched)."""
    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.models.swinunetr import WindowAttention3D

    cfg = train_config("float32", 1, 0, "step")
    batch = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                     seed=cfg.seed))
    watched = [f"swinViT.layers{i}.0.blocks.{b}.attn.{t}" for i in (1, 4) for b in (0, 1)
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    kernel_launches = (sum(FWD_PER_STEP.values()), sum(BWD_PER_STEP.values()))
    step_parity(torch, wa, cfg, batch, watched, WindowAttention3D, kernel_launches, "[step]")


def step_parity(torch, wa, cfg, batch, watched, attention_type, kernel_launches, tag) -> None:
    """One f32 step through the kernels against the same step (same
    weights, same batch, drop path off) with the plain attention, beside a
    control: the kernel step on the batch scaled by 1 + 1e-7, which shows
    how far f32 rounding of the forward alone moves the step."""
    import gc

    from icl_tpu_torch.models.layers import DropPath
    from icl_tpu_torch.train.trainer import Trainer

    def one_step(plain: bool, input_scale: float = 1.0):
        trainer = Trainer(cfg, device=DEVICE)
        for m in trainer.model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
            if plain and isinstance(m, attention_type):
                m.attention = wa.window_attention_plain
        params = dict(trainer.model.named_parameters())
        before = {n: params[n].detach().clone() for n in watched}
        on_card = trainer.to_device(batch)
        on_card["image"] = on_card["image"] * input_scale
        wa.reset_launch_counts()
        metrics = {k: float(v) for k, v in trainer.step_fn(on_card).items()}
        launches = (wa.window_attention.launches, wa.window_attention_bwd.launches)
        after = {n: params[n].detach().clone() for n in watched}
        del trainer, params, on_card
        gc.collect()
        torch.cuda.empty_cache()
        return metrics, before, after, launches

    kern, plain, ctl = one_step(False), one_step(True), one_step(False, 1.0 + 1e-7)
    launches = [run[3] for run in (kern, plain, ctl)]
    if launches != [kernel_launches, (0, 0), kernel_launches]:
        fail(f"(forward, backward) launches of the kernel, plain and control steps: {launches}, "
             f"expected {[kernel_launches, (0, 0), kernel_launches]}")
    for n in watched:
        if not (torch.equal(kern[1][n], plain[1][n]) and torch.equal(kern[1][n], ctl[1][n])):
            fail(f"{n}: the steps did not start from the same weights")

    def loss_err(a, b):
        return {k: abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]}

    def update_err(a, b):
        """max |a - b| of each new value over the allowance: the tolerance
        times the largest update, plus two f32 ulps of the largest weight."""
        out = {}
        for n in watched:
            allow = (STEP_UPDATE_RTOL * float((b[2][n] - b[1][n]).abs().max())
                     + 2 * torch.finfo(torch.float32).eps * float(b[1][n].abs().max()))
            out[n] = float((a[2][n] - b[2][n]).abs().max()) / allow
        return out

    errs = {"kernel_vs_plain": (loss_err(kern, plain), update_err(kern, plain)),
            "control_vs_kernel": (loss_err(ctl, kern), update_err(ctl, kern))}
    print(f"{tag} one f32 step, kernel vs plain attention: loss terms {kern[0]} vs {plain[0]}",
          flush=True)
    for name, (le, ue) in errs.items():
        print(f"{tag} {name}: loss terms' relative errors {le} (tolerance {STEP_LOSS_RTOL}); "
              f"updated tensors' errors as fractions of their allowance {ue}", flush=True)
    le, ue = errs["kernel_vs_plain"]
    if any(e > STEP_LOSS_RTOL for e in le.values()) or any(e > 1.0 for e in ue.values()):
        fail("the training step through the kernels disagrees with the plain-attention step")


def phase_train_to_eval(torch, held_out, training: dict) -> None:
    """11: the stripped best checkpoint through the eval CLI's loader."""
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics
    from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model

    model = load_eval_model("swinunetr_icl", training["best_path"], 2, DEVICE, FEATURE_SIZE)
    agg = aggregate_case_metrics(evaluate_brats_cases(
        make_patch_predictor(model), held_out, 2, (PATCH,) * 3, STRIDE, STRIDE, sw_batch=SW_BATCH,
        device=DEVICE))
    print(f"[eval] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean dice "
          f"{agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def inputs_2d(torch, stage, dtype, gen, kind, batch=LABELED_2D):
    """q, k, v, bias and the mask of one Swin-UNet 2D attention shape at
    `batch`: `kind` None (no mask), "shift" (the shifted block's mask) or
    "random" (a dense mask N(0, 3^2): the kernels take any)."""
    from icl_tpu_torch.models.swin2d import shifted_window_mask

    _, side, ws, heads, _ = stage
    nW, N = (side // ws) ** 2, ws * ws
    q, k, v = (torch.randn(batch * nW, heads, N, HEAD_DIM_2D, device=DEVICE, generator=gen)
               .to(dtype) for _ in range(3))
    bias = torch.randn(heads, N, N, device=DEVICE, generator=gen)
    mask = None
    if kind == "shift":
        mask = torch.from_numpy(shifted_window_mask(side, side, ws, ws // 2)).to(DEVICE)
    elif kind == "random":
        mask = 3.0 * torch.randn(nW, N, N, device=DEVICE, generator=gen)
    return q, k, v, bias, mask


def check_2d(torch, F, wa, stage, mode, kind, dtype, gen, batch=LABELED_2D, timed=None,
             tag="2d") -> tuple[dict, dict]:
    """The forward and backward kernels at one 2D shape against their plain
    versions, bitwise-repeatable; timed (f32 with the shift mask or none,
    unless `timed` says) beside the bound, the plain version and SDPA."""
    scale = HEAD_DIM_2D ** -0.5
    q, k, v, bias, mask = inputs_2d(torch, stage, dtype, gen, kind, batch)
    B, H, N, D = q.shape
    nW = mask.shape[0] if mask is not None else B
    if timed is None:
        timed = dtype == torch.float32 and kind != "random"
    got = wa.window_attention(q, k, v, bias, mask=mask, scale=scale)
    again = wa.window_attention(q, k, v, bias, mask=mask, scale=scale)
    torch.cuda.synchronize()
    want = wa.window_attention_plain(q, k, v, bias, mask=mask, scale=scale)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        ok = float(err.max()) <= F32_ATOL
    else:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    row = {"stage": stage[0], "mode": mode, "mask": kind, "dtype": str(dtype).split(".")[-1],
           "shape": list(q.shape), "nW": nW if mask is not None else None,
           "max_abs_err": float(err.max()), "bitwise_repeat": torch.equal(got, again)}
    if not ok or not row["bitwise_repeat"] or not torch.isfinite(got).all():
        fail(f"2D kernel disagrees with plain or is not repeatable: {row}")
    if timed:
        shape = (B // nW, nW, H, N, D) if mask is not None else (B, H, N, D)
        qs, ks, vs = (t.view(shape) for t in (q, k, v))
        attn = bias if mask is None else bias[None] + mask[:, None]
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn, scale=scale)
        row.update(
            ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, mask=mask, scale=scale)),
            plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, mask=mask,
                                                               scale=scale)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=attn, scale=scale)),
            library_max_abs_err=float((lib_out.reshape(q.shape) - want).abs().max()),
            before_ms=FWD2D_BEFORE_MS.get((stage[0], mode)),
            **bound_fields(*bound(B, H, N, D, mask.numel() if mask is not None else 0)),
        )
        del lib_out, attn
    print(f"[kernel{tag}] {json.dumps(row)}", flush=True)
    del again
    g = torch.randn(q.shape, device=DEVICE, generator=gen).to(dtype)
    got = wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale, mask=mask)
    again = wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale, mask=mask)
    torch.cuda.synchronize()
    want = wa.window_attention_plain_bwd(q, k, v, bias, None, g, scale=scale, mask=mask)
    names = ("dq", "dk", "dv", "dbias")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    tols = {n: BWD_F32_RTOL if dtype == torch.float32 or n == "dbias" else BWD_BF16_RTOL
            for n in names}
    brow = {k: row[k] for k in ("stage", "mode", "mask", "dtype", "shape", "nW")}
    brow.update(rel_err=errs, tolerance=tols,
                max_abs_err=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(got, want)),
                bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    if not finite or not brow["bitwise_repeat"] or any(errs[n] > tols[n] for n in names):
        fail(f"2D backward kernel disagrees with plain or is not repeatable: {brow}")
    if timed:
        brow.update(
            ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, None, g, scale=scale,
                                                       mask=mask)),
            plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                q, k, v, bias, None, g, scale=scale, mask=mask), reps=3),
            library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, mask, g, scale),
            before_ms=BWD2D_BEFORE_MS.get((stage[0], mode)),
            **bound_fields(*bound(B, H, N, D, mask.numel() if mask is not None else 0,
                                  backward=True)),
        )
    print(f"[bwd{tag}] {json.dumps(brow)}", flush=True)
    del q, k, v, bias, mask, g, got, again, want
    torch.cuda.empty_cache()
    return row, brow


def phase_kernels_2d(torch, F, wa) -> tuple[list[dict], list[dict]]:
    """12 + 13: the forward and backward kernels at the 2D shapes (384^2,
    the reference's 224^2 stage 1 and a 2 x 2 window) against their plain
    versions; f32 times with the shift mask."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    fwd_rows, bwd_rows = [], []
    for stage in STAGES_2D + [REF_STAGE_2D, TINY_STAGE_2D]:
        for mode in stage[4]:
            for kind in ((None,) if mode == "none" else ("shift", "random")):
                for dtype in (torch.float32, torch.bfloat16):
                    row, brow = check_2d(torch, F, wa, stage, mode, kind, dtype, gen)
                    fwd_rows.append(row)
                    bwd_rows.append(brow)
    return fwd_rows, bwd_rows


def train_config_2d(max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.swin2d import SwinConfig

    return ExperimentConfig(
        root_path="in-memory", exp="ACDC_chip_smoke/SwinICL", model="icl_swinunet",
        num_classes=CLASSES_2D, max_iterations=max_iterations, batch_size=BATCH_2D,
        labeled_bs=LABELED_2D, base_lr=0.01, patch_size=(IMG_2D, IMG_2D), seed=1337, labeled_num=7,
        num_tries=tries, consis_weight=50.0, val_interval=val_interval, log_interval=1,
        precision="float32", experiments_dir=EXPERIMENTS,
        model_kwargs={"swin_cfg": SwinConfig(img_size=IMG_2D, window_size=WINDOW_2D)})


def acdc_batches(slices, cfg):
    from icl_tpu_torch.data.pipeline import acdc_train_batches

    return acdc_train_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, cfg.patch_size,
                              seed=cfg.seed)


def phase_training_2d(torch, wa, slices, volumes) -> dict:
    """14: Trainer.fit of Swin-UNet-ICL at full width, the main path of
    this slice."""
    import gc

    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    cfg = train_config_2d(TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    probe = acdc_batches(slices, cfg)  # the host's time per batch, apart from the run
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        next(probe)
    host_batch_s = (time.perf_counter() - t0) / TRAIN_STEPS
    validate = acdc_evaluator(volumes, CLASSES_2D, cfg.patch_size, trainer.device)
    per_steps, val_s = {}, []

    def evaluate(model):
        per_steps["fwd"] = dict(wa.window_attention.launches_by_mode)
        per_steps["bwd"] = dict(wa.window_attention_bwd.launches_by_mode)
        t0 = time.perf_counter()
        agg = validate(model)  # ends with the label maps on the host
        val_s.append(time.perf_counter() - t0)
        return agg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    result = trainer.fit(acdc_batches(slices, cfg), evaluate=evaluate)
    torch.cuda.synchronize()
    drop_states(result)
    path = {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged 2D steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite 2D loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    chunks = sum(math.ceil(v["image"].shape[0] / 32) for v in volumes)
    val_launches = {m: path["fwd"][m] - per_steps["fwd"][m] for m in PER_FORWARD_2D}
    print(f"[train2d] Swin-UNet-ICL embed 96, {n_params} params, built in {build_s:.1f} s; "
          f"{IMG_2D}^2 window {WINDOW_2D}, batch {BATCH_2D} ({LABELED_2D} labeled), f32, TF32 off: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start; host batch "
          f"{host_batch_s:.4f} s of it); peak memory {peak / 2**30:.2f} GiB; launches over the "
          f"steps {per_steps}, validation ({chunks} chunks) {val_launches}", flush=True)
    for r in log:
        print(f"[train2d] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[train2d] validation at step {val['iteration']} on {len(volumes)} volumes of "
          f"{VOL_DEPTH_2D} {SLICE_SIZE_2D}^2 slices in {val_s[0]:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    for kind in ("fwd", "bwd"):
        if per_steps[kind] != {"none": TRAIN_STEPS * PER_STEP_2D["none"], "region": 0,
                               "mask": TRAIN_STEPS * PER_STEP_2D["mask"]}:
            fail(f"2D {kind} launches over {TRAIN_STEPS} steps: {per_steps[kind]}, expected "
                 f"{PER_STEP_2D} per step")
    if val_launches != {m: chunks * n for m, n in PER_FORWARD_2D.items()} or path["bwd"] != per_steps["bwd"]:
        fail(f"2D validation launches {val_launches} over {chunks} chunks, expected "
             f"{PER_FORWARD_2D} per chunk and no backward")
    if result["best_path"] is None:
        fail(f"2D validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "host_batch_s": host_batch_s, "peak_bytes": peak,
            "path_launches": path, "val_dice": val["mean_dice"], "best_path": result["best_path"],
            "swin_cfg": cfg.model_kwargs["swin_cfg"]}


def phase_step_parity_2d(torch, wa, slices) -> None:
    """15: one Swin-UNet-ICL step through the kernels against the plain
    attention (encoder stages 1 and 4 and the masked decoder block)."""
    from icl_tpu_torch.models.swin2d import WindowAttention

    cfg = train_config_2d(1, 0, "step")
    blocks = [f"layers.{i}.blocks.{b}" for i in (0, 3) for b in (0, 1)] + ["layers_up.3.blocks.1"]
    watched = [f"swin_unet.{blk}.attn.{t}" for blk in blocks
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    per_step = sum(PER_STEP_2D.values())
    step_parity(torch, wa, cfg, next(acdc_batches(slices, cfg)), watched, WindowAttention,
                (per_step, per_step), "[step2d]")


def phase_train_to_eval_2d(torch, volumes, training: dict) -> None:
    """16: the stripped best checkpoint through the 2D eval CLI's loader."""
    from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor
    from icl_tpu_torch.scripts.test_2D_ACDC import load_eval_model

    patch = (IMG_2D, IMG_2D)
    model = load_eval_model("icl_swinunet", training["best_path"], CLASSES_2D, DEVICE, patch,
                            {"swin_cfg": training["swin_cfg"]})
    agg = evaluate_acdc_volumes(make_slice_predictor(model, patch, DEVICE), volumes, CLASSES_2D)
    print(f"[eval2d] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean "
          f"dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the 2D eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def unet_config(max_iterations: int, val_interval: int, tries: str, side: int | None = None,
                **model_kwargs):
    from icl_tpu_torch.config import ExperimentConfig

    side = side or IMG_UNET
    return ExperimentConfig(
        root_path="in-memory", exp="ACDC_chip_smoke/ICL", model="icl_unet", num_classes=CLASSES_2D,
        max_iterations=max_iterations, batch_size=BATCH_2D, labeled_bs=LABELED_2D, base_lr=0.01,
        patch_size=(side, side), seed=1337, labeled_num=7, num_tries=tries, consis_weight=50.0,
        val_interval=val_interval, log_interval=1, precision="float32",
        experiments_dir=EXPERIMENTS, model_kwargs=model_kwargs)


def phase_training_unet(torch, wa, slices, volumes) -> dict:
    """17: Trainer.fit of U-Net-ICL at full width, its batches made on a
    Prefetcher thread; no window attention on this path."""
    import gc

    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.scripts.time_fit import timed
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    cfg = unet_config(TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # dropout and drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    validate = acdc_evaluator(volumes, CLASSES_2D, cfg.patch_size, trainer.device)
    waits, val_s = [], []  # the time each `next` blocks the step's thread; the validation's

    def evaluate(model):
        t0 = time.perf_counter()
        agg = validate(model)  # ends with the label maps on the host
        val_s.append(time.perf_counter() - t0)
        return agg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(acdc_batches(slices, cfg), pin_memory=trainer.device.type == "cuda") as batches:
        wa.reset_launch_counts()
        result = trainer.fit(timed(batches, waits), evaluate=evaluate)
        torch.cuda.synchronize()
        drop_states(result)
        path = {"fwd": dict(wa.window_attention.launches_by_mode),
                "bwd": dict(wa.window_attention_bwd.launches_by_mode)}
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged U-Net steps and a validation, got {result}")
    bad = [(r["iteration"], k) for r in log for k in METRIC_KEYS if not math.isfinite(r[k])]
    if bad:
        fail(f"non-finite U-Net loss terms {bad}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    print(f"[unet] U-Net-ICL, {n_params} params, built and initialised in {build_s:.2f} s; "
          f"{IMG_UNET}^2, batch {BATCH_2D} ({LABELED_2D} labeled), f32, TF32 off: {s_per_step:.4f} "
          f"s/step after the warm-up step (step times {[round(r['seconds'], 4) for r in log]} s "
          f"from the start); the step's thread waited {[round(w, 4) for w in waits]} s for its "
          f"batches (Prefetcher); peak memory {peak / 2**30:.2f} GiB; window-attention launches "
          f"{path}", flush=True)
    for r in log:
        print(f"[unet] step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in METRIC_KEYS), flush=True)
    val = result["vals"][-1]
    print(f"[unet] validation at step {val['iteration']} on {len(volumes)} volumes of "
          f"{VOL_DEPTH_2D} {SLICE_SIZE_2D}^2 slices in {val_s[0]:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    if any(n for counts in path.values() for n in counts.values()):
        fail(f"the U-Net path launched window attention: {path}")
    if result["best_path"] is None:
        fail(f"U-Net validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "waits_s": waits, "val_s": val_s[0], "build_s": build_s,
            "n_params": n_params, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"]}


def step_agreement(torch, tag: str, what: str, before: dict, runs: dict) -> None:
    """runs: {"test", "reference"} and optionally "control" and "witness"
    -> (loss terms, parameters after) of one step each from the parameters
    `before` (in the test's dtype); the control is the test's step on the
    batch scaled by 1 + 1e-7, the witness the test's step on the
    reference's device in the test's dtype. Loss terms within
    STEP_LOSS_RTOL; each parameter's new value within STEP_UPDATE_RTOL of
    its largest update plus two ulps of its largest weight, or, where the
    control moves it further, within twice the control's distance, or,
    where the witness lies further from the reference, within
    STEP_WITNESS_FACTOR times the witness's distance: in f32 the gradients
    of the layers that feed a train-mode BatchNorm (the convs, and `mlp2`
    through the SeparableConv) cancel, so a change of the input at the f32
    rounding level, or f32 rounding alone, can move them past the fixed
    allowance (tests/test_torch_train_unet2d.py)."""
    test, ref = runs["test"], runs["reference"]
    ctl, wit = runs.get("control"), runs.get("witness")
    loss_err = {k: abs(test[0][k] - ref[0][k]) / max(abs(ref[0][k]), 1e-12) for k in ref[0]}
    errs, ctl_errs, wit_errs = {}, {}, {}
    for n, w in before.items():
        allow = (STEP_UPDATE_RTOL * float((ref[1][n] - w).abs().max())
                 + 2 * torch.finfo(w.dtype).eps * float(w.abs().max()))
        err = float((test[1][n] - ref[1][n]).abs().max())
        ctl_err = float((ctl[1][n] - test[1][n]).abs().max()) if ctl else 0.0
        wit_err = float((wit[1][n] - ref[1][n]).abs().max()) if wit else 0.0
        errs[n] = (ratio(err, allow),
                   ratio(err, max(allow, 2 * ctl_err, STEP_WITNESS_FACTOR * wit_err)))
        ctl_errs[n] = ratio(ctl_err, allow)
        wit_errs[n] = ratio(wit_err, allow)
    top = dict(sorted(errs.items(), key=lambda kv: -kv[1][1])[:5])
    beyond = sorted(n for n, (fixed, _) in errs.items() if fixed > 1.0)
    print(f"{tag} {what}: loss terms {test[0]} vs {ref[0]}; relative errors {loss_err} (tolerance "
          f"{STEP_LOSS_RTOL}); of {len(errs)} parameters {len(beyond)} beyond the fixed allowance "
          f"{beyond}; the largest errors as fractions of (the fixed allowance, the rule's) {top}",
          flush=True)
    if ctl:
        top_ctl = dict(sorted(ctl_errs.items(), key=lambda kv: -kv[1])[:5])
        print(f"{tag} the control's largest moves as fractions of the fixed allowance {top_ctl}",
              flush=True)
    if wit:
        top_wit = dict(sorted(wit_errs.items(), key=lambda kv: -kv[1])[:5])
        print(f"{tag} the witness's largest errors as fractions of the fixed allowance {top_wit}; "
              f"the test's errors on those tensors {({n: errs[n][0] for n in top_wit})}",
              flush=True)
    if (any(e > STEP_LOSS_RTOL for e in loss_err.values())
            or any(e > 1.0 for _, e in errs.values())):
        fail(f"{tag} {what}: the steps disagree")


def ratio(err: float, allow: float) -> float:
    """err / allow, with 0 / 0 = 0 (a parameter at zero that no step moved)."""
    return err / allow if allow > 0 else (0.0 if err == 0 else math.inf)


def unet_step(torch, model, batch, patch, device, input_scale: float = 1.0,
              classes: int = CLASSES_2D, labeled: int = LABELED_2D, consis: float = 50.0):
    """(loss terms, parameters after) of one ICL step of `model` (f32 or
    f64) at patch `patch` on `batch`, with a fresh optimizer. The
    parameters are the model's own tensors: clone them before the model
    moves on."""
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_icl_step

    dtype = next(model.parameters()).dtype
    model.zero_grad(set_to_none=True)
    opt = PolySGD(model.parameters(), 0.01, 30000)
    step = make_icl_step(model, opt, classes, labeled, tuple(patch), consis)
    on_device = {"image": torch.as_tensor(batch["image"]).to(device, dtype) * input_scale,
                 "label": torch.as_tensor(batch["label"]).to(device).long()}
    metrics = {k: float(v) for k, v in step(on_device).items()}
    return metrics, {n: p.detach() for n, p in model.named_parameters()}


def phase_unet_device_vs_cpu(torch, slices) -> None:
    """18: one U-Net-ICL step at 64^2 on the card against the CPU."""
    from icl_tpu_torch.models.registry import net_factory

    cfg = unet_config(1, 0, "cpu", side=IMG_UNET_CPU)
    batch = next(acdc_batches(slices, cfg))

    starts = []

    def run(device, scale=1.0):
        model = net_factory("icl_unet", 1, CLASSES_2D, device=device, patch_size=IMG_UNET_CPU,
                            zero_stochastic=True, generator=torch.Generator().manual_seed(cfg.seed))
        starts.append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
        metrics, after = unet_step(torch, model, batch, (IMG_UNET_CPU,) * 2, device, scale)
        return metrics, {n: t.cpu().clone() for n, t in after.items()}

    t0 = time.perf_counter()
    runs = {"test": run(DEVICE), "reference": run("cpu"), "control": run(DEVICE, 1.0 + 1e-7)}
    if not all(torch.equal(s[n], starts[0][n]) for s in starts for n in starts[0]):
        fail("[unet-cpu] the steps did not start from the same weights")
    step_agreement(torch, "[unet-cpu]", f"one {IMG_UNET_CPU}^2 f32 step, card vs CPU "
                   f"({time.perf_counter() - t0:.1f} s for the three)", starts[0], runs)


def phase_unet_fused_pair(torch, slices) -> None:
    """19: one full-width U-Net-ICL step with the fused sspa pair against the
    two-call step, on the card, in f64 (the two differ by how their GEMMs
    are batched, which in f32 moves the layers that feed a BatchNorm past
    any fixed allowance; in f64 the steps must agree), from one model whose
    weights and BatchNorm stats are reset between the steps."""
    import gc

    from icl_tpu_torch.models.registry import net_factory

    batch = next(acdc_batches(slices, unet_config(1, 0, "fused")))
    model = net_factory("icl_unet", 1, CLASSES_2D, device=DEVICE, patch_size=IMG_UNET,
                        zero_stochastic=True, generator=torch.Generator().manual_seed(0)).double()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()

    def run(fuse: bool):
        model.load_state_dict(start)
        model.fuse_sspa_pair = fuse
        return unet_step(torch, model, batch, (IMG_UNET,) * 2, DEVICE)

    t0 = time.perf_counter()
    metrics, after = run(False)
    reference = (metrics, {n: t.clone() for n, t in after.items()})
    runs = {"test": run(True), "reference": reference}
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    before = {n: start[n] for n in reference[1]}
    step_agreement(torch, "[unet-fused]", f"one {IMG_UNET}^2 f64 step, fused sspa pair vs two calls "
                   f"({step_s:.1f} s for the two; peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", before, runs)
    del model, start, runs, reference, after, before
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_to_eval_unet(torch, volumes, training: dict) -> None:
    """20: the stripped best checkpoint through the 2D eval CLI's loader."""
    from icl_tpu_torch.eval.infer2d import evaluate_acdc_volumes, make_slice_predictor
    from icl_tpu_torch.scripts.test_2D_ACDC import load_eval_model

    patch = (IMG_UNET, IMG_UNET)
    model = load_eval_model("icl_unet", training["best_path"], CLASSES_2D, DEVICE, patch)
    agg = evaluate_acdc_volumes(make_slice_predictor(model, patch, DEVICE), volumes, CLASSES_2D)
    print(f"[eval-unet] stripped best checkpoint, loaded strictly into {type(model).__name__}: mean "
          f"dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}", flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the U-Net eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def unet3d_config(model: str, precision: str, max_iterations: int, val_interval: int, tries: str):
    from icl_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(
        root_path="in-memory", exp="BraTS_chip_smoke/UNet3D", model=model, num_classes=2,
        max_iterations=max_iterations, batch_size=TRAIN_BATCH, labeled_bs=LABELED_BS,
        base_lr=0.01, patch_size=(PATCH,) * 3, seed=1337, labeled_num=2, num_tries=tries,
        consis_weight=10.0, val_interval=val_interval, log_interval=1, precision=precision,
        experiments_dir=EXPERIMENTS)


def launches_now(wa) -> dict:
    return {"fwd": dict(wa.window_attention.launches_by_mode),
            "bwd": dict(wa.window_attention_bwd.launches_by_mode)}


def no_attention(tag: str, path: dict) -> None:
    if any(n for counts in path.values() for n in counts.values()):
        fail(f"{tag} the 3D U-Net path launched window attention: {path}")


def print_log(tag: str, log: list, keys) -> None:
    bad = [(r["iteration"], k) for r in log for k in keys if not math.isfinite(r[k])]
    if bad:
        fail(f"{tag} non-finite loss terms {bad}")
    for r in log:
        print(f"{tag} step {r['iteration']} lr {r['lr']:.6f} "
              + " ".join(f"{k} {r[k]:.6f}" for k in keys), flush=True)


def phase_training_unet3d(torch, wa, cases, held_out) -> dict:
    """21: Trainer.fit of U-Net-ICL 3D on BraTS at full width, its batches
    made on a Prefetcher thread, then one bf16 step; no window attention."""
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.scripts.time_fit import timed
    from icl_tpu_torch.train.steps import METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer, brats_evaluator

    cfg = unet3d_config("unet_3D_icl", "float32", TRAIN_STEPS, TRAIN_STEPS, "float32")
    torch.manual_seed(0)  # dropout and drop-path masks
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.model.parameters())
    validate = brats_evaluator(held_out, 2, cfg.patch_size, trainer.device)
    waits = []

    def batches():
        return brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                   seed=cfg.seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(batches(), pin_memory=trainer.device.type == "cuda") as prefetched:
        wa.reset_launch_counts()
        result = trainer.fit(timed(prefetched, waits), evaluate=validate, class_names=["WT"])
        torch.cuda.synchronize()
        drop_states(result)
        path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    log = result["log"]
    if len(log) != TRAIN_STEPS or not result["vals"]:
        fail(f"expected {TRAIN_STEPS} logged U-Net-ICL 3D steps and a validation, got {result}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    print(f"[unet3d] U-Net-ICL 3D, {n_params} params, built and initialised in {build_s:.2f} s; "
          f"BraTS {PATCH}^3, batch {TRAIN_BATCH} ({LABELED_BS} labeled), 2 classes, f32, TF32 off: "
          f"{s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); the step's thread waited "
          f"{[round(w, 4) for w in waits]} s for its batches (Prefetcher); peak memory "
          f"{peak / 2**30:.2f} GiB; window-attention launches {path}", flush=True)
    print_log("[unet3d]", log, METRIC_KEYS)
    val = result["vals"][-1]
    print(f"[unet3d] validation at step {val['iteration']} on one held-out {CASE_SIZE}^3 case in "
          f"{val['seconds']:.4f} s: mean dice {val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best "
          f"checkpoint {result['best_path']}", flush=True)
    no_attention("[unet3d]", path)
    if result["best_path"] is None:
        fail(f"U-Net-ICL 3D validation dice {val['mean_dice']}: no best checkpoint was saved")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    trainer = Trainer(unet3d_config("unet_3D_icl", "bfloat16", 1, 0, "bfloat16"), device=DEVICE)
    result16 = trainer.fit(batches())
    drop_states(result16)
    log16 = result16["log"]
    print("[unet3d] one bfloat16 autocast step: "
          + " ".join(f"{k} {log16[0][k]:.6f}" for k in METRIC_KEYS), flush=True)
    if not all(math.isfinite(log16[0][k]) for k in METRIC_KEYS):
        fail("non-finite U-Net-ICL 3D loss under bfloat16")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": s_per_step, "waits_s": waits, "val_s": val["seconds"],
            "build_s": build_s, "n_params": n_params, "peak_bytes": peak, "path_launches": path,
            "val_dice": val["mean_dice"], "best_path": result["best_path"]}


def phase_unet3d_device_vs_cpu(torch, cases) -> None:
    """22: one U-Net-ICL 3D step at 32^3 on the card against the CPU."""
    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.models.registry import net_factory

    patch = (UNET3D_CPU,) * 3
    batch = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, patch, seed=1337))
    starts = []

    def run(device, scale=1.0):
        model = net_factory("unet_3D_icl", 1, 2, device=device, patch_size=UNET3D_CPU,
                            zero_stochastic=True, generator=torch.Generator().manual_seed(1337))
        starts.append({n: p.detach().cpu().clone() for n, p in model.named_parameters()})
        metrics, after = unet_step(torch, model, batch, patch, device, scale, classes=2,
                                   labeled=LABELED_BS, consis=10.0)
        return metrics, {n: t.cpu().clone() for n, t in after.items()}

    t0 = time.perf_counter()
    runs = {"test": run(DEVICE), "reference": run("cpu"), "control": run(DEVICE, 1.0 + 1e-7)}
    if not all(torch.equal(s[n], starts[0][n]) for s in starts for n in starts[0]):
        fail("[unet3d-cpu] the steps did not start from the same weights")
    step_agreement(torch, "[unet3d-cpu]", f"one {UNET3D_CPU}^3 f32 step, card vs CPU "
                   f"({time.perf_counter() - t0:.1f} s for the three)", starts[0], runs)


def phase_supervised_unet3d(torch, wa, cases) -> dict:
    """23: two steps of the supervised U-Net 3D on BraTS through fit."""
    import gc

    from icl_tpu_torch.data.brats import brats_supervised_batches
    from icl_tpu_torch.data.pipeline import Prefetcher
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS
    from icl_tpu_torch.train.trainer import Trainer

    cfg = unet3d_config("unet_3D", "float32", 2, 0, "supervised")
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Prefetcher(brats_supervised_batches(cases, TRAIN_BATCH, cfg.patch_size, seed=cfg.seed),
                    pin_memory=trainer.device.type == "cuda") as batches:
        wa.reset_launch_counts()
        result = trainer.fit(batches)
        torch.cuda.synchronize()
        drop_states(result)
        log = result["log"]
        path = launches_now(wa)
    print(f"[unet3d-sup] supervised U-Net 3D, BraTS {PATCH}^3, batch {TRAIN_BATCH}, f32: step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; window-attention launches {path}",
          flush=True)
    if len(log) != 2:
        fail(f"expected 2 logged supervised steps, got {log}")
    print_log("[unet3d-sup]", log, SUPERVISED_METRIC_KEYS)
    no_attention("[unet3d-sup]", path)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"path_launches": path, "log": log}


def amos_cli(torch, wa, module: str, argv: list, keys) -> dict:
    """One AMOS training CLI's `main(argv)` from AMOS_ROOT, with the
    window-attention counts and the peak memory of the run."""
    import gc
    import importlib

    cli = importlib.import_module(f"icl_tpu_torch.scripts.{module}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    drop_states(result)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    tag = f"[{module}]"
    steps = len(log)
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (steps - 1)
    print(f"{tag} {steps} steps: {s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start, the first waiting for the "
          f"cases' preprocessing); whole run {run_s:.2f} s; peak memory {peak / 2**30:.2f} GiB; "
          f"window-attention launches {path}", flush=True)
    print_log(tag, log, keys)
    for val in result["vals"]:
        print(f"{tag} validation at step {val['iteration']} in {val['seconds']:.4f} s: mean dice "
              f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint "
              f"{result['best_path']}", flush=True)
    no_attention(tag, path)
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path,
            "vals": result["vals"], "best_path": result["best_path"], "log": log}


def phase_amos(torch, wa) -> tuple[dict, dict]:
    """25 - 27: the AMOS ICL CLI for 3 steps and a validation, the
    supervised CLI for 2 steps, then test_3D_AMOS on the stripped best
    checkpoint, all on a seeded synthetic NIfTI tree."""
    from icl_tpu_torch.data.synth import make_synthetic_amos
    from icl_tpu_torch.scripts import test_3D_AMOS
    from icl_tpu_torch.train.steps import METRIC_KEYS, SUPERVISED_METRIC_KEYS

    shutil.rmtree(AMOS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    jpath = make_synthetic_amos(AMOS_ROOT, AMOS_CASES, AMOS_SHAPE, AMOS_SPACING, seed=0)
    print(f"[amos] synthetic tree of {AMOS_CASES} cases {AMOS_SHAPE} at spacing {AMOS_SPACING} "
          f"written in {time.perf_counter() - t0:.2f} s", flush=True)
    common = ["--root_path", AMOS_ROOT, "--split_path", jpath, "--val_num", "1"]
    cwd = os.getcwd()
    os.chdir(AMOS_ROOT)  # the CLIs' snapshots land in ../experiments
    try:
        torch.manual_seed(0)
        icl = amos_cli(torch, wa, "train_inherent_consistent_unet_3D_AMOS22",
                       common + ["--exp", "AMOS_chip_smoke/ICL", "--labeled_num", "2",
                                 "--total_num", str(AMOS_CASES - 1), "--max_iterations",
                                 str(TRAIN_STEPS), "--val_interval", str(TRAIN_STEPS),
                                 "--num_tries", "bfloat16"], METRIC_KEYS)
        if len(icl["log"]) != TRAIN_STEPS or not icl["vals"] or icl["best_path"] is None:
            fail(f"[amos] expected {TRAIN_STEPS} steps, a validation and a best checkpoint")
        sup = amos_cli(torch, wa, "train_fully_supervised_unet_3D_AMOS22",
                       common + ["--exp", "AMOS_chip_smoke/Fully_Supervised", "--labeled_num",
                                 str(AMOS_CASES - 1), "--max_iterations", "2", "--val_interval",
                                 "0", "--num_tries", "float32"], SUPERVISED_METRIC_KEYS)
        if len(sup["log"]) != 2:
            fail(f"[amos] expected 2 supervised steps, got {sup['log']}")
        total = test_3D_AMOS.main(common[:4] + ["--exp", "AMOS_chip_smoke/ICL", "--labeled_num",
                                                "2", "--num_tries", "bfloat16", "--val_num", "0"])
    finally:
        os.chdir(cwd)
    val_dice = icl["vals"][-1]["mean_dice"]
    print(f"[eval-amos] test_3D_AMOS on the stripped best checkpoint, loaded strictly into UNet3D: "
          f"mean dice {float(total[0])!r}, the trainer's validation {val_dice!r}", flush=True)
    if total[0] != val_dice:
        fail("the AMOS eval CLI does not reproduce the trainer's validation dice")
    return icl, sup


def phase_train_to_eval_unet3d(torch, held_out, training: dict) -> None:
    """24: the BraTS stripped best checkpoint through test_3D_BraTS's loader
    with --model unet_3D_icl."""
    from icl_tpu_torch.eval.infer3d import evaluate_brats_cases, make_patch_predictor
    from icl_tpu_torch.metrics import aggregate_case_metrics
    from icl_tpu_torch.scripts.test_3D_BraTS import load_eval_model

    model = load_eval_model("unet_3D_icl", training["best_path"], 2, DEVICE)
    metric_cal = evaluate_brats_cases(make_patch_predictor(model), held_out, 2, (PATCH,) * 3, STRIDE,
                                      STRIDE, sw_batch=SW_BATCH, device=DEVICE)
    agg = aggregate_case_metrics(metric_cal)
    print(f"[eval-unet3d] stripped best checkpoint, loaded strictly into {type(model).__name__}: "
          f"mean dice {agg['mean_dice']!r}, the trainer's validation {training['val_dice']!r}",
          flush=True)
    if agg["mean_dice"] != training["val_dice"]:
        fail("the 3D U-Net eval path does not reproduce the trainer's validation dice")
    del model
    torch.cuda.empty_cache()


def drop_states(result: dict) -> None:
    """Delete the train states a `fit` wrote (several GB each for the ICL
    models); the best checkpoints stay for the train -> eval phases."""
    for save in result.get("saves", []):
        if os.path.exists(save["path"]):
            os.remove(save["path"])


def phase_kernels_supervised(torch, F, wa) -> dict:
    """28: the kernels at the supervised paths' shapes, against their
    plain versions and timed beside the bound, the plain version and SDPA:
    Swin-UNet at 224^2 / window 7, batch 16, f32 (stages 1-4, forward and
    backward, with the shift mask and without); SwinUNETR at batch 4 in
    bf16 (stages 1-4, forward and backward, with region ids and without;
    the bound at the bf16 rate and 2-byte q, k, v)."""
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    rows = {"fwd2d": [], "bwd2d": [], "fwd3d": [], "bwd3d": []}
    for stage in STAGES_SWIN_SUP:
        for mode in stage[4]:
            row, brow = check_2d(torch, F, wa, stage, mode, None if mode == "none" else "shift",
                                 torch.float32, gen, batch=BATCH_SWIN_SUP, tag="-sup2d")
            rows["fwd2d"].append(row)
            rows["bwd2d"].append(brow)
    scale = HEAD_DIM ** -0.5
    for stage in STAGES:
        name = stage[0]
        for mode in ("none", "region"):
            if name not in PER_FORWARD[mode]:
                continue
            q, k, v, bias, ids = stage_inputs(torch, (name, TRAIN_BATCH) + stage[2:],
                                              torch.bfloat16, gen)
            ids = ids if mode == "region" else None
            B, H, N, D = q.shape
            nW = ids.shape[0] if ids is not None else B
            got = wa.window_attention(q, k, v, bias, ids, scale=scale)
            again = wa.window_attention(q, k, v, bias, ids, scale=scale)
            want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
            err = (got.float() - want.float()).abs()
            row = {"stage": name, "mode": mode, "dtype": "bfloat16", "shape": list(q.shape),
                   "nW": ids.shape[0] if ids is not None else None, "max_abs_err": float(err.max()),
                   "bitwise_repeat": torch.equal(got, again)}
            if (not bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                    or not row["bitwise_repeat"] or not torch.isfinite(got).all()):
                fail(f"bf16 kernel disagrees with plain or is not repeatable: {row}")
            dense = wa.mask_from_region_ids(ids) if ids is not None else None
            if ids is None:
                attn, qs, ks, vs = bias.to(q.dtype), q, k, v
            else:
                attn = (bias[None] + dense[:, None]).to(q.dtype)
                qs, ks, vs = (t.view(B // nW, nW, H, N, D) for t in (q, k, v))
            bf16_bound = dict(elem_bytes=2, flops_rate=BF16_FLOPS)
            mask_floats = ids.numel() if ids is not None else 0
            row.update(
                ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=attn, scale=scale)),
                **bound_fields(*bound(B, H, N, D, mask_floats, **bf16_bound)))
            print(f"[kernel-sup3d] {json.dumps(row)}", flush=True)
            rows["fwd3d"].append(row)
            del attn, qs, ks, vs
            g = torch.randn(q.shape, device=DEVICE, generator=gen).to(q.dtype)
            got = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
            again = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)
            want = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale)
            names = ("dq", "dk", "dv", "dbias")
            errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
            tols = {n: BWD_F32_RTOL if n == "dbias" else BWD_BF16_RTOL for n in names}
            brow = {k: row[k] for k in ("stage", "mode", "dtype", "shape", "nW")}
            brow.update(rel_err=errs, tolerance=tols,
                        max_abs_err=max(float((a.float() - b.float()).abs().max())
                                        for a, b in zip(got, want)),
                        bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)))
            if (not all(bool(torch.isfinite(a).all()) for a in got) or not brow["bitwise_repeat"]
                    or any(errs[n] > tols[n] for n in names)):
                fail(f"bf16 backward kernel disagrees with plain or is not repeatable: {brow}")
            brow.update(
                ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)),
                plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                    q, k, v, bias, ids, g, scale=scale), reps=3),
                library_ms=sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
                **bound_fields(*bound(B, H, N, D, mask_floats, backward=True, **bf16_bound)))
            print(f"[bwd-sup3d] {json.dumps(brow)}", flush=True)
            rows["bwd3d"].append(brow)
            del q, k, v, bias, g, got, again, want, dense
            torch.cuda.empty_cache()
    return rows


class InMemoryDataset:
    """The dataset classes' interface (`cls(root, split, num=...)`) over
    in-memory items: the card's machine has no h5py to read the h5 trees.
    "train" gives the training items (the first `num`), any other split
    the held-out ones."""

    def __init__(self, train: list, held_out: list):
        self.train, self.held_out = train, held_out

    def __call__(self, base_dir, split="train", num=None, **_):
        return (self.train[:num] if num is not None else self.train) if split == "train" \
            else self.held_out


def run_cli(torch, wa, cli, argv: list, dataset_attr: str, data: InMemoryDataset,
            tag: str, keys, steps: int, per_step=None, need_best: bool = True) -> dict:
    """`cli.main(argv)` from SUP_ROOT (its snapshot lands in EXPERIMENTS)
    with the CLI's dataset class over in-memory data; s/step, peak memory,
    every loss term, the validation, the best checkpoint; the
    window-attention launches of the steps (snapshotted before the
    validation through the CLI's evaluator) and of the whole run; the
    train states deleted after."""
    import gc

    per_steps = {}
    evaluator_name = "brats_evaluator" if hasattr(cli, "brats_evaluator") else "acdc_evaluator"
    real_evaluator = getattr(cli, evaluator_name)

    def evaluator(*a, **k):
        validate = real_evaluator(*a, **k)

        def evaluate(model):
            per_steps.setdefault("at_validation", launches_now(wa))
            return validate(model)

        return evaluate

    saved = {dataset_attr: getattr(cli, dataset_attr), evaluator_name: real_evaluator}
    setattr(cli, dataset_attr, data)
    setattr(cli, evaluator_name, evaluator)
    os.makedirs(SUP_ROOT, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for attr, value in saved.items():
            setattr(cli, attr, value)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    drop_states(result)
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    if len(log) != steps or not result["vals"] or (need_best and result["best_path"] is None) \
            or not 0.0 <= result["vals"][-1]["mean_dice"] <= 1.0:
        fail(f"{tag} expected {steps} steps, a validation and a best checkpoint, got {result}")
    s_per_step = (log[-1]["seconds"] - log[0]["seconds"]) / (len(log) - 1)
    at_val = per_steps["at_validation"]
    print(f"{tag} {steps} steps: {s_per_step:.4f} s/step after the warm-up step (step times "
          f"{[round(r['seconds'], 4) for r in log]} s from the start); whole run {run_s:.2f} s; "
          f"peak memory {peak / 2**30:.2f} GiB; window-attention launches over the steps {at_val}, "
          f"whole run {path}; final state save {result['saves'][-1]['bytes'] / 1e9:.2f} GB in "
          f"{result['saves'][-1]['seconds']:.2f} s", flush=True)
    print_log(tag, log, keys)
    val = result["vals"][-1]
    print(f"{tag} validation at step {val['iteration']} in {val['seconds']:.4f} s: mean dice "
          f"{val['mean_dice']!r} hd95 {val['mean_hd95']!r}; best checkpoint {result['best_path']}",
          flush=True)
    if per_step is not None:
        for kind in ("fwd", "bwd"):
            want = {m: steps * per_step[kind].get(m, 0) for m in ("none", "region", "mask")}
            if at_val[kind] != want:
                fail(f"{tag} {kind} launches over {steps} steps: {at_val[kind]}, expected {want}")
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": at_val,
            "run_launches": path, "val_dice": val["mean_dice"], "val_s": val["seconds"],
            "best_path": result["best_path"], "log": log,
            "saves": [{k: v[k] for k in ("iteration", "bytes", "seconds")} for v in result["saves"]]}


def phase_supervised_unet_2d(torch, wa, slices, volumes) -> dict:
    """29: the supervised U-Net 2D CLI at its defaults (256^2, batch 16,
    f32) for 3 steps and a validation, then test_2D_ACDC --model unet on its
    best checkpoint; no window attention."""
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_unet_2D_ACDC as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    data = InMemoryDataset(slices, volumes)
    common = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fully_Supervised",
              "--num_tries", "unet"]
    torch.manual_seed(0)
    run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS), "--val_interval",
                                            str(TRAIN_STEPS)], "ACDCDataset", data, "[sup-unet]",
                  SUPERVISED_METRIC_KEYS, TRAIN_STEPS)
    no_attention("[sup-unet]", run["run_launches"])
    eval_dice = eval_cli(test_2D_ACDC, common + ["--model", "unet"], "ACDCDataset", data)
    print(f"[eval-sup-unet] test_2D_ACDC --model unet on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_2D_ACDC does not reproduce the supervised U-Net's validation dice")
    return run


def eval_cli(module, argv: list, dataset_attr: str, data: InMemoryDataset) -> float:
    """`module.main(argv)` (an eval CLI) from SUP_ROOT over in-memory data:
    its mean dice."""
    saved = getattr(module, dataset_attr)
    setattr(module, dataset_attr, data)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        return float(module.main(argv)[0])
    finally:
        os.chdir(cwd)
        setattr(module, dataset_attr, saved)


def phase_supervised_swinunet_2d(torch, wa, slices, volumes) -> dict:
    """30: the supervised Swin-UNet CLI at its defaults (224^2, window 7,
    batch 16, f32) from a synthetic ImageNet-layout Swin-T checkpoint (a
    seeded model's encoder, a classification head and one key of the wrong
    shape, which must be dropped) for 3 steps and a validation, with the
    launches per step asserted; one step through the kernels against the
    plain attention by phase 15's rule; test_2D_ACDC --model swinunet on the
    best checkpoint."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swin2d import WindowAttention
    from icl_tpu_torch.scripts import test_2D_ACDC
    from icl_tpu_torch.scripts import train_fully_supervised_swinunet_2D_ACDC as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    donor = net_factory("swinunet", 1, CLASSES_2D, device="cpu",
                        generator=torch.Generator().manual_seed(30))
    encoder = {k[len("swin_unet."):]: v for k, v in donor.state_dict().items()
               if k.startswith(("swin_unet.layers.", "swin_unet.patch_embed.", "swin_unet.norm."))}
    wrong = "layers.2.blocks.0.attn.qkv.weight"
    ckpt = {**encoder, "head.weight": torch.ones(1000, 768), "head.bias": torch.zeros(1000),
            wrong: torch.zeros(5, 7)}
    os.makedirs(SUP_ROOT, exist_ok=True)
    ckpt_path = os.path.join(SUP_ROOT, "swin_tiny_synthetic.pth")
    torch.save({"model": ckpt}, ckpt_path)
    del donor
    loads = []
    real_load = cli.load_pretrained_swinunet

    def load(model, path):
        loads.append(real_load(model, path))
        return loads[-1]

    cli.load_pretrained_swinunet = load
    data = InMemoryDataset(slices, volumes)
    common = ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fully_Supervised",
              "--num_tries", "swinunet"]
    per_step = {kind: dict(PER_FORWARD_SWIN_SUP) for kind in ("fwd", "bwd")}
    try:
        torch.manual_seed(0)  # drop-path masks
        run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS),
                                                "--val_interval", str(TRAIN_STEPS),
                                                "--pretrained_ckpt", ckpt_path],
                      "ACDCDataset", data, "[sup-swinunet]", SUPERVISED_METRIC_KEYS, TRAIN_STEPS,
                      per_step)
    finally:
        cli.load_pretrained_swinunet = real_load
    kept, dropped = loads[0]
    reasons = dict(dropped)
    shape_drops = sorted(k for k, r in dropped if r.startswith("shape"))
    print(f"[sup-swinunet] --pretrained_ckpt: {len(kept)} keys loaded, {len(dropped)} dropped, "
          f"for their shape {shape_drops}; the head {[k for k in reasons if k.startswith('head.')]}",
          flush=True)
    if shape_drops != [f"swin_unet.{wrong}", f"swin_unet.layers_up.1.blocks.0.attn.qkv.weight"] \
            or "head.weight" not in reasons or not any(k.startswith("swin_unet.layers_up.") for k in kept):
        fail("[sup-swinunet] the pretrained load did not keep and drop the expected keys")
    chunks = sum(math.ceil(v["image"].shape[0] / 32) for v in volumes)
    val_fwd = {m: run["run_launches"]["fwd"][m] - run["path_launches"]["fwd"][m]
               for m in ("none", "mask")}
    if val_fwd != {m: chunks * n for m, n in PER_FORWARD_SWIN_SUP.items()}:
        fail(f"[sup-swinunet] validation launches {val_fwd} over {chunks} chunks, expected "
             f"{PER_FORWARD_SWIN_SUP} per chunk")
    cfg = ExperimentConfig(root_path="in-memory", exp="ACDC_chip_smoke/SwinSup", model="swinunet",
                           num_classes=CLASSES_2D, max_iterations=1, batch_size=BATCH_SWIN_SUP,
                           base_lr=0.01, patch_size=(IMG_SWIN_SUP,) * 2, seed=1337,
                           val_interval=0, precision="float32", experiments_dir=EXPERIMENTS)
    from icl_tpu_torch.data.pipeline import supervised_batches

    batch = next(supervised_batches(slices, BATCH_SWIN_SUP, cfg.patch_size, seed=cfg.seed))
    blocks = [f"layers.{i}.blocks.{b}" for i in (0, 3) for b in (0, 1)] + ["layers_up.3.blocks.1"]
    watched = [f"swin_unet.{blk}.attn.{t}" for blk in blocks
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]
    per = sum(PER_FORWARD_SWIN_SUP.values())
    step_parity(torch, wa, cfg, batch, watched, WindowAttention, (per, per), "[step-sup2d]")
    eval_dice = eval_cli(test_2D_ACDC, common + ["--model", "swinunet", "--patch_size",
                                                 str(IMG_SWIN_SUP), str(IMG_SWIN_SUP)],
                         "ACDCDataset", data)
    print(f"[eval-sup-swinunet] test_2D_ACDC --model swinunet on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_2D_ACDC does not reproduce the supervised Swin-UNet's validation dice")
    return run


def phase_supervised_swinunetr_3d(torch, wa, cases, held_out) -> dict:
    """31: the supervised SwinUNETR CLI at its defaults (fs48, 96^3, batch
    4, bf16, recompute on) from a synthetic SSL SwinViT checkpoint in the
    reference layout (`module.swin_vit.`, `mlp.linear1/linear2`) for 3 steps
    and a validation, with the launches per step asserted; test_3D_BraTS
    --model swinunetr on the best checkpoint."""
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.scripts import test_3D_BraTS
    from icl_tpu_torch.scripts import train_fully_supervised_swinunetr_3D_BraTS as cli
    from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS

    donor = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(31))
    ssl = {f"module.swin_vit.{k[len('swinViT.'):]}": v for k, v in donor.state_dict().items()
           if k.startswith("swinViT.")}
    os.makedirs(SUP_ROOT, exist_ok=True)
    ckpt_path = os.path.join(SUP_ROOT, "model_swinvit_synthetic.pt")
    torch.save({"state_dict": ssl, "epoch": 0}, ckpt_path)
    n_params = sum(1 for k, _ in donor.named_parameters() if k.startswith("swinViT."))
    del donor
    loads = []
    real_load = cli.load_pretrained_swinvit

    def load(model, path):
        loads.append(real_load(model, path))
        return loads[-1]

    cli.load_pretrained_swinvit = load
    data = InMemoryDataset(cases, held_out)
    common = ["--root_path", "in-memory-BraTS", "--exp", "BraTS_chip_smoke/Fully_Supervised",
              "--num_tries", "swinunetr", "--labeled_num", str(len(cases))]
    per_step = {"fwd": SUP_3D_FWD_PER_STEP, "bwd": SUP_3D_BWD_PER_STEP}
    try:
        torch.manual_seed(0)  # drop-path masks
        run = run_cli(torch, wa, cli, common + ["--max_iterations", str(TRAIN_STEPS),
                                                "--val_interval", str(TRAIN_STEPS),
                                                "--ssl_ckpt", ckpt_path],
                      "BraTS2019Dataset", data, "[sup-swinunetr]", SUPERVISED_METRIC_KEYS,
                      TRAIN_STEPS, per_step)
    finally:
        cli.load_pretrained_swinvit = real_load
    kept, dropped = loads[0]
    print(f"[sup-swinunetr] --ssl_ckpt: {len(kept)} keys loaded (the encoder has {n_params} "
          f"parameters), {len(dropped)} dropped ({sorted(set(r for _, r in dropped))})", flush=True)
    if len(kept) != n_params:
        fail("[sup-swinunetr] the SSL load did not fill every encoder parameter")
    eval_dice = eval_cli(test_3D_BraTS, common + ["--model", "swinunetr"], "BraTS2019Dataset", data)
    print(f"[eval-sup-swinunetr] test_3D_BraTS --model swinunetr on the best checkpoint: mean dice "
          f"{eval_dice!r}, the trainer's validation {run['val_dice']!r}", flush=True)
    if eval_dice != run["val_dice"]:
        fail("test_3D_BraTS does not reproduce the supervised SwinUNETR's validation dice")
    return run


def flat(state: dict) -> dict:
    """A train state (`Trainer.train_state`) as {name: tensor}."""
    out = {f"model/{k}": v for k, v in state["model"].items()}
    out.update({f"momentum/{i}": s["momentum_buffer"]
                for i, s in state["optimizer"]["state"].items()})
    out.update({f"rng/{k}": v for k, v in state["rng"].items() if k != "modules"})
    out.update({f"rng/modules/{k}": v for k, v in state["rng"]["modules"].items()})
    return out


def phase_resume(torch, slices) -> dict:
    """32: resume on the flagship U-Net-ICL 2D at full width. Run A takes 4
    steps; run B takes 2 with checkpoint_interval 2 (the rolling save, then
    the final one), and a fresh Trainer restores `state_last` (every
    parameter, buffer, momentum, the count, the iteration and the RNG
    states equal to run B's bit for bit) and takes A's batches 3-4. The
    caller runs the phase under cuDNN's deterministic algorithms: after
    step 4, B must equal A bit for bit, as must a repeat of run A (no
    kernel of the 2D step adds with atomics since the linear resizes became
    matmuls). The train states are deleted after."""
    import gc

    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils.checkpoint import host_copy

    def config(tries, interval=0):
        cfg = unet_config(RESUME_STEPS, 0, tries)
        cfg.checkpoint_interval = interval
        return cfg

    def params_on_host(trainer):
        return {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}

    def run(tries, batches, interval=0):
        """A fresh Trainer from the seed through `fit`: (trainer, result)."""
        torch.manual_seed(0)  # dropout and drop-path masks
        trainer = Trainer(config(tries, interval), device=DEVICE)
        return trainer, trainer.fit(batches)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    batches = [b for _, b in zip(range(RESUME_STEPS), acdc_batches(slices, config("batches")))]
    torch.manual_seed(0)  # dropout and drop-path masks
    a = Trainer(config("resumeA"), device=DEVICE)
    result_a = a.fit(batches)
    state_a = flat(host_copy(a.train_state()))
    drop_states(result_a)
    del a
    release()

    first, result_first = run("resumeB", batches[:2], interval=2)
    rolling, last = result_first["saves"]
    torch.manual_seed(1)  # the restore must bring back the generators' states
    b = Trainer(config("resumeB", 2), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.restore_state()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    saved, restored = flat(first.train_state()), flat(b.train_state())
    differ = sorted(k for k in saved if k not in restored or saved[k].dtype != restored[k].dtype
                    or not torch.equal(saved[k].to(restored[k].device), restored[k]))
    scalars = {k: (first.train_state()[k], b.train_state()[k]) for k in ("count", "iteration")}
    del first, saved, restored
    release()
    nbytes = last["bytes"]
    print(f"[resume] U-Net-ICL 2D {IMG_UNET}^2, state {nbytes / 1e9:.3f} GB: rolling save "
          f"{rolling['seconds']:.2f} s ({rolling['bytes'] / 1e9 / rolling['seconds']:.2f} GB/s), "
          f"final save {last['seconds']:.2f} s ({nbytes / 1e9 / last['seconds']:.2f} GB/s), "
          f"restore_state {restore_s:.2f} s ({nbytes / 1e9 / restore_s:.2f} GB/s); restored tensors "
          f"that differ from the saved ones: {differ or 'none'}; (count, iteration) saved vs "
          f"restored {scalars}", flush=True)
    if differ or any(x != y for x, y in scalars.values()) or scalars["iteration"][1] != 2:
        fail("[resume] the restored state is not the saved one bit for bit")
    result_b = b.fit(batches[2:])
    if [r["iteration"] for r in result_b["log"]] != [3, 4]:
        fail(f"[resume] the resumed run logged {[r['iteration'] for r in result_b['log']]}")
    state_b = flat(host_copy(b.train_state()))
    del b
    release()

    again, result_again = run("resumeRepeat", batches)
    state_again = flat(host_copy(again.train_state()))
    del again
    release()
    for result in (result_first, result_b, result_again):
        drop_states(result)

    def differ_from_a(state):
        n = sum(not torch.equal(state_a[k], state[k]) for k in state_a)
        return "bitwise equal" if not n else f"{n} of {len(state_a)} tensors differ"

    print(f"[resume] after step {RESUME_STEPS}, A (4 steps) vs B (2 + restore + 2): "
          f"{differ_from_a(state_b)}; A vs a repeat of A from the same seed: "
          f"{differ_from_a(state_again)}", flush=True)
    differ_ab = [k for k in state_a if not torch.equal(state_a[k], state_b[k])]
    if differ_ab or differ_from_a(state_again) != "bitwise equal":
        fail("[resume] B and a repeat of A must equal A bit for bit under cuDNN's deterministic "
             "algorithms")
    return {"bytes": nbytes, "rolling_s": rolling["seconds"], "final_s": last["seconds"],
            "restore_s": restore_s, "bitwise": not differ_ab}


def cta_snapshot(exp: str) -> str:
    """The FixMatch-CTA CLI's snapshot for `--exp exp` from SUP_ROOT (its
    default --labeled_num 7 and --num_tries 1)."""
    return os.path.join(EXPERIMENTS, f"{exp}_7_labeled", "unet_exp_1")


def cta_cli(torch, wa, argv: list, data: InMemoryDataset, tag: str) -> dict:
    """The FixMatch-CTA CLI's `main(argv)` from SUP_ROOT at its defaults
    (256^2, batch 16 of which 8 labeled, the U-Net, f32) over in-memory
    slices, the first LABELED_SLICES_2D labeled: s/step after the warm-up
    step, peak memory, every loss term, the mask ratio and proximity per
    step, the window-attention launches of the run (asserted: none)."""
    import gc

    from icl_tpu_torch.scripts import train_fixmatch_cta_2D as cli
    from icl_tpu_torch.train.steps import FIXMATCH_METRIC_KEYS

    saved = {"ACDCDataset": cli.ACDCDataset, "patients_to_slices": cli.patients_to_slices}
    cli.ACDCDataset = data
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    os.makedirs(SUP_ROOT, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(SUP_ROOT)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wa.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(argv + ["--root_path", "in-memory-ACDC"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for attr, value in saved.items():
            setattr(cli, attr, value)
    path = launches_now(wa)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log = result["log"]
    # from the start of step 2 to the end of the last step, whose metrics
    # the loop reads after it (the others' are read one step late)
    s_per_step = (log[-1]["seconds"] - log[1]["started"]) / (len(log) - 1)
    print(f"{tag} {len(log)} steps: {s_per_step:.4f} s/step after the warm-up step (steps started "
          f"at {[round(r['started'], 4) for r in log]} s from the start, their metrics read at "
          f"{[round(r['seconds'], 4) for r in log]} s); whole run {run_s:.2f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; window-attention launches {path}", flush=True)
    print_log(tag, log, FIXMATCH_METRIC_KEYS)
    no_attention(tag, path)
    return {"s_per_step": s_per_step, "peak_bytes": peak, "path_launches": path, "log": log,
            "saves": result["saves"], "run_s": run_s}


def moved_bins(path: str) -> tuple[int, int]:
    """(rate bins off 1.0, all bins) of a cta_state.json."""
    with open(path) as f:
        rates = json.load(f)["rates"]
    values = [v for bins in rates.values() for r in bins for v in r]
    return sum(v != 1.0 for v in values), len(values)


def phase_fixmatch_cta(torch, wa, slices, volumes) -> dict:
    """33: the FixMatch-CTA CLI at the JAX CLI's defaults on phase 14's
    slices: 4 steps with --checkpoint_interval 2 --cta_rate_lag 1, then 2
    with --cta_rate_lag 0; the host seconds of one cta_batches batch made
    alone, and of the step alone on a batch made before; the rate bins
    that moved (asserted: some)."""
    import gc

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.train.cta import CTATrainer

    data = InMemoryDataset(slices, volumes)
    for exp in (CTA_EXP, CTA_EXP_LAG0):
        shutil.rmtree(os.path.dirname(cta_snapshot(exp)), ignore_errors=True)
    torch.manual_seed(0)
    lag1 = cta_cli(torch, wa, ["--exp", CTA_EXP, "--max_iterations", str(CTA_STEPS),
                               "--checkpoint_interval", "2", "--cta_rate_lag", "1"], data, "[cta]")
    lag0 = cta_cli(torch, wa, ["--exp", CTA_EXP_LAG0, "--max_iterations", "2",
                               "--checkpoint_interval", "2", "--cta_rate_lag", "0"], data, "[cta-lag0]")
    if [r["iteration"] for r in lag1["log"]] != list(range(1, CTA_STEPS + 1)) \
            or [r["iteration"] for r in lag0["log"]] != [1, 2]:
        fail("[cta] the runs did not log their steps")
    moved = {lag: moved_bins(os.path.join(cta_snapshot(exp), "model", "cta_state.json"))
             for lag, exp in (("lag1", CTA_EXP), ("lag0", CTA_EXP_LAG0))}
    print(f"[cta] rate bins moved off 1.0 (of all bins): {moved}", flush=True)
    if not all(n for n, _ in moved.values()):
        fail("[cta] no rate bin moved")

    batches = cta_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (IMG_UNET, IMG_UNET),
                          CTAugment(seed=1337), seed=1337)
    batch_s = []
    for _ in range(CTA_HOST_BATCHES):
        t0 = time.perf_counter()
        batch = next(batches)
        batch_s.append(time.perf_counter() - t0)
    cfg = ExperimentConfig(root_path="in-memory-ACDC", exp=CTA_EXP, model="unet",
                           num_classes=CLASSES_2D, batch_size=BATCH_2D, labeled_bs=LABELED_2D,
                           patch_size=(IMG_UNET, IMG_UNET), experiments_dir=EXPERIMENTS)
    trainer = CTATrainer(cfg, device=DEVICE)
    on_device = trainer.to_device(batch)
    step_s = []
    for _ in range(CTA_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_fn(on_device)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(f"[cta] one cta_batches batch ({BATCH_2D} slices and a probe at {IMG_UNET}^2) made alone "
          f"on the host: {[round(t, 4) for t in batch_s]} s, median "
          f"{sorted(batch_s)[len(batch_s) // 2]:.4f}; the step alone on a batch made before: "
          f"{[round(t, 4) for t in step_s]} s (the first warms up)", flush=True)
    del trainer, on_device
    gc.collect()
    torch.cuda.empty_cache()
    return {"lag1": lag1, "lag0": lag0, "moved": moved, "batch_s": batch_s, "step_s": step_s,
            "path_launches": {k: {m: lag1["path_launches"][k].get(m, 0)
                                  + lag0["path_launches"][k].get(m, 0)
                                  for m in ("none", "region", "mask")} for k in ("fwd", "bwd")}}


def fixmatch_step(torch, model, batch, device, conf: float, input_scale: float = 1.0):
    """(metrics, parameters after, the separate probe's proximity) of one
    FixMatch-CTA step with the fused probe of `model` (f32 or f64) on
    `batch`, with a fresh optimizer."""
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_fixmatch_cta_step, probe_proximity

    model.zero_grad(set_to_none=True)
    opt = PolySGD(model.parameters(), 0.01, 30000)
    step = make_fixmatch_cta_step(model, opt, CLASSES_2D, LABELED_2D, conf, 1.0)
    dtype = next(model.parameters()).dtype
    on_device = {k: torch.as_tensor(batch[k]).to(device, dtype) * input_scale
                 for k in ("image_weak", "image_strong", "probe_image")}
    on_device.update({k: torch.as_tensor(batch[k]).to(device).long()
                      for k in ("label_aug", "probe_label")})
    metrics = {k: float(v) for k, v in step(on_device).items()}
    separate = float(probe_proximity(model, on_device["probe_image"], on_device["probe_label"]))
    return metrics, {n: p.detach() for n, p in model.named_parameters()}, separate


def phase_fixmatch_device_vs_cpu(torch, slices) -> None:
    """34: one FixMatch-CTA step at 64^2 on the card against the CPU (same
    weights and batch, dropout off) over the loss terms and every
    parameter: in f64 beside a control step by the rule of 18; in f32
    against the CPU's f64 step, with the CPU's f32 step as the witness of
    f32 rounding (STEP_WITNESS_FACTOR). The same mask on every step, at a
    threshold clear of every confidence; the fused proximity against a
    separate probe forward on the card."""
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.data.pipeline import cta_batches
    from icl_tpu_torch.models.layers import Dropout
    from icl_tpu_torch.models.registry import net_factory

    side = IMG_UNET_CPU
    batch = next(cta_batches(slices, LABELED_SLICES_2D, BATCH_2D, LABELED_2D, (side, side),
                             CTAugment(seed=1337), seed=1337))

    def build(device, dtype):
        model = net_factory("unet", 1, CLASSES_2D, device=device,
                            generator=torch.Generator().manual_seed(1337)).to(dtype)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        return model

    # the threshold: the middle of the widest gap between the confidences of
    # the first weak pass (f64, on the CPU) from their 30th to their 70th
    # percentile, so that about half the pixels are kept and none lies
    # within rounding of it on either device (one pixel across it moves the
    # unsupervised gradient more than any rounding does)
    with torch.no_grad():
        logits = build("cpu", torch.float64)(torch.as_tensor(batch["image_weak"]).double())
    confs = torch.softmax(logits[LABELED_2D:], 1).amax(1).flatten().sort().values
    lo, hi = int(0.3 * len(confs)), int(0.7 * len(confs))
    gaps = confs[lo + 1:hi] - confs[lo:hi - 1]
    widest = int(gaps.argmax())
    conf = float((confs[lo + widest] + confs[lo + widest + 1]) / 2)
    pixels = (BATCH_2D - LABELED_2D) * side * side
    f32, f64 = torch.float32, torch.float64
    starts, runs, separate = {}, {}, {}
    t0 = time.perf_counter()
    for name, device, dtype, scale in (("f64 test", DEVICE, f64, 1.0), ("f64 reference", "cpu", f64, 1.0),
                                       ("f64 control", DEVICE, f64, 1.0 + 1e-7),
                                       ("f32 test", DEVICE, f32, 1.0), ("f32 witness", "cpu", f32, 1.0)):
        model = build(device, dtype)
        starts[name] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        metrics, after, separate[name] = fixmatch_step(torch, model, batch, device, conf, scale)
        runs[name] = (metrics, {n: t.cpu().clone() for n, t in after.items()})
    first = starts["f64 test"]
    if not all(torch.equal(s[n].double(), first[n]) for s in starts.values() for n in first):
        fail("[cta-cpu] the steps did not start from the same weights")
    masks = {k: r[0]["mask_ratio"] for k, r in runs.items()}
    fused = {k: runs[k][0]["probe_proximity"] for k in ("f64 test", "f32 test")}
    print(f"[cta-cpu] threshold {conf:.7f}, {float(gaps[widest]) / 2:.2e} from the nearest "
          f"confidence: mask ratios {masks} of {pixels} pixels; fused probe proximity on the card "
          f"{fused}, a separate probe forward {({k: separate[k] for k in fused})} (tolerance "
          f"{CTA_PROXIMITY_ATOL}); the five steps in {time.perf_counter() - t0:.1f} s", flush=True)
    if not 0.0 < masks["f64 test"] < 1.0 or len(set(masks.values())) != 1:
        fail("[cta-cpu] the mask is empty or full, or the steps' masks part")
    if any(abs(fused[k] - separate[k]) > CTA_PROXIMITY_ATOL for k in fused):
        fail("[cta-cpu] the fused probe disagrees with a separate probe forward")
    step_agreement(torch, "[cta-cpu]", f"one {side}^2 f64 FixMatch-CTA step, card vs CPU",
                   first, {"test": runs["f64 test"], "reference": runs["f64 reference"],
                           "control": runs["f64 control"]})
    step_agreement(torch, "[cta-cpu]", f"one {side}^2 f32 FixMatch-CTA step on the card vs the "
                   f"CPU's f64 step (witness: the CPU's f32 step)", starts["f32 test"],
                   {"test": runs["f32 test"], "reference": runs["f64 reference"],
                    "witness": runs["f32 witness"]})


def phase_fixmatch_resume(torch, wa, slices, volumes, cta: dict) -> dict:
    """35: a fresh CTATrainer restores phase 33's rate-lag-1 save at step
    CTA_STEPS (state_last and cta_state.json): the restored state equals
    the saved one bit for bit, the rates the saved JSON; then the CLI's
    --resume takes 2 more steps (iterations 5, 6, the rolling save
    step_00000006, then state_last)."""
    import gc

    import numpy as np

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.data.ctaugment import CTAugment
    from icl_tpu_torch.train.cta import CTATrainer
    from icl_tpu_torch.utils import checkpoint as ckpt
    from icl_tpu_torch.utils.checkpoint import host_copy

    snapshot = cta_snapshot(CTA_EXP)
    cfg = ExperimentConfig(root_path="in-memory-ACDC", exp=CTA_EXP, model="unet",
                           num_classes=CLASSES_2D, max_iterations=CTA_STEPS + 2,
                           batch_size=BATCH_2D, labeled_bs=LABELED_2D,
                           patch_size=(IMG_UNET, IMG_UNET), labeled_num=7, num_tries="1",
                           checkpoint_interval=2, experiments_dir=EXPERIMENTS)
    if cfg.snapshot_path != snapshot:
        fail(f"[cta-resume] snapshot {cfg.snapshot_path} is not the CLI's {snapshot}")
    trainer = CTATrainer(cfg, device=DEVICE)
    t0 = time.perf_counter()
    iteration = trainer.restore_state()
    restore_s = time.perf_counter() - t0
    saved = flat(ckpt.load_train_state(snapshot, "last", "cpu"))
    restored = flat(host_copy(trainer.train_state()))
    differ = sorted(k for k in saved if k not in restored or saved[k].dtype != restored[k].dtype
                    or not torch.equal(saved[k], restored[k]))
    learner = CTAugment(seed=0)
    CTATrainer.restore_cta(snapshot, learner)
    with open(os.path.join(snapshot, "model", "cta_state.json")) as f:
        want = json.load(f)["rates"]
    rate_diff = [k for k, bins in want.items()
                 if not all(np.array_equal(np.asarray(r, np.float32), got)
                            for r, got in zip(bins, learner.rates[k]))]
    print(f"[cta-resume] restore_state at iteration {iteration} in {restore_s:.3f} s: restored "
          f"tensors that differ from the saved ones: {differ or 'none'} (of {len(saved)}); ops whose "
          f"restored rates differ from cta_state.json: {rate_diff or 'none'}", flush=True)
    if iteration != CTA_STEPS or differ or rate_diff or len(restored) != len(saved):
        fail("[cta-resume] the restored state or rates are not the saved ones")
    del trainer
    gc.collect()
    run = cta_cli(torch, wa, ["--exp", CTA_EXP, "--max_iterations", str(CTA_STEPS + 2),
                              "--checkpoint_interval", "2", "--cta_rate_lag", "1", "--resume"],
                  InMemoryDataset(slices, volumes), "[cta-resume]")
    its = [r["iteration"] for r in run["log"]]
    names = [os.path.basename(s["path"]) for s in run["saves"]]
    print(f"[cta-resume] the resumed run logged iterations {its} and saved {names}", flush=True)
    if its != [CTA_STEPS + 1, CTA_STEPS + 2] \
            or names != [f"state_step_{CTA_STEPS + 2:08d}.pt", "state_last.pt"]:
        fail("[cta-resume] the resumed run did not continue from its step")
    for result in (cta["lag1"], cta["lag0"], run):
        drop_states(result)
    return {"restore_s": restore_s, "iterations": its, "saves": names}


# This slice: the flagship's fast configuration, the JAX CLI's
# `--fuse_icl_pair --precision bfloat16 --state_dtype bfloat16 --input_mode
# device_bank --scan_steps 4 --dispatch_depth 2` (bench.py's
# icl_unet_acdc_fast): U-Net-ICL 2D at 256^2, batch 16 of which 8 labeled,
# on phase 14's slices held on the card; its SGD update the stochastic-
# rounding kernel, one launch per parameter leaf.
FAST_ARGV = ["--fuse_icl_pair", "--precision", "bfloat16", "--state_dtype", "bfloat16",
             "--input_mode", "device_bank", "--scan_steps", "4", "--dispatch_depth", "2"]
FAST_STEPS, FAST_CHECKPOINT = 8, 4
GRAPH_STEPS = 4
# the SR kernel's shapes: the flagship's largest leaf (`mlp2`, 16384^2), a
# small leaf, a ragged length, and the ragged length at an address that is
# not 16-byte aligned (the kernel's scalar path)
SGD_SHAPES = {"mlp2_16384x16384": (268_435_456, 0), "small_4096": (4096, 0),
              "ragged_1000003": (1_000_003, 0), "ragged_unaligned": (1_000_003, 1)}
SGD_REPLACES = "icl_tpu/train/optim.py:_sgd_bf16_state (XLA)"
# The window-attention launches of one supervised Swin-UNet step (224^2,
# window 7, batch 16): 8 no-mask + 6 mask, forward and backward.
SWIN_SUP_PER_STEP = {"none": 8, "mask": 6}


def run_card_tests() -> dict:
    """The card's kernel tests (JAX-free, without tests/conftest.py), both
    files in one pytest: {file: passed}; fatal on any failure or skip."""
    files = ["tests/test_torch_window_attention_card.py", "tests/test_torch_sgd_bf16_card.py"]
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                           "-q", "-rs", "-m", "cuda", *files], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else proc.stderr[-2000:]
    print(f"[card-tests] {' '.join(files)}: {tail}", flush=True)
    if proc.returncode != 0 or "skipped" in tail or "passed" not in tail:
        print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
        fail("[card-tests] the card's kernel tests did not all pass")
    return {"summary": tail}


def fast_config(tries: str, max_iterations: int, **kw):
    """The flagship's fast configuration as an ExperimentConfig (the CLI's
    FAST_ARGV), with a checkpoint every FAST_CHECKPOINT steps."""
    cfg = unet_config(max_iterations, 0, tries)
    cfg.precision, cfg.state_dtype, cfg.fuse_icl_pair = "bfloat16", "bfloat16", True
    cfg.device_augment, cfg.scan_steps, cfg.dispatch_depth = True, 4, 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def fast_batches(torch, slices, cfg, n: int) -> list:
    """The first n bank batches of the flagship CLI's device_bank branch
    (the bank of `slices` on the card, the two-stream indices, the draws)."""
    from icl_tpu_torch.data.device_bank import bank_batches, build_acdc_bank, two_stream_index_batches

    image_bank, label_bank = build_acdc_bank(slices, int(cfg.patch_size[0]), DEVICE)
    indices = two_stream_index_batches(LABELED_SLICES_2D, len(slices), cfg.batch_size,
                                       cfg.labeled_bs, seed=cfg.seed)
    stream = bank_batches(image_bank, label_bank, indices, seed=cfg.seed)
    return [next(stream) for _ in range(n)]


def phase_sgd_kernel(torch, sg) -> dict:
    """36: the SR kernel against its plain version, bit for bit, and bitwise
    across two runs, at SGD_SHAPES; then over the flagship's 300 leaves
    (1.15 B parameters): the kernel per call (host-issued) and on the device
    alone (queued behind a GPU sleep), beside the bound, the plain version,
    torch.optim.SGD(fused=True) on the same bf16 tensors (round-to-nearest
    stores: the nearest PyTorch call, not the same function) and the f32
    PolySGD step on an f32 state of the same shapes."""
    import gc

    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.train.optim import PolySGD

    gen = torch.Generator(device=DEVICE).manual_seed(36)
    lr = torch.tensor(0.01, device=DEVICE)
    count = torch.tensor(7, dtype=torch.int64, device=DEVICE)

    def draw(n, off=0, scale=1.0):
        return (torch.randn(n + off, generator=gen, device=DEVICE) * scale).to(torch.bfloat16)[off:]

    shapes = {}
    for name, (n, off) in SGD_SHAPES.items():
        p, g, buf = draw(n, off, 0.05), draw(n, off, 0.01), draw(n, off, 0.01)
        runs = []
        for update in (sg.sgd_bf16_update, sg.sgd_bf16_update, sg.sgd_bf16_plain):
            pc, bc = p.clone(), buf.clone()
            update(pc, g, bc, lr, count, 0.9, 1e-4, 0, 3)
            runs.append((pc, bc))
        torch.cuda.synchronize()
        differ = {w: [int((runs[i][j] != runs[2][j]).sum()) for j in (0, 1)]
                  for i, w in ((0, "kernel vs plain"), (1, "repeat vs plain"))}
        repeat = all(torch.equal(runs[0][j], runs[1][j]) for j in (0, 1))
        moved = int((runs[0][0] != p).sum())
        shapes[name] = {"n": n, "aligned": off == 0, "differ_p_buf": differ, "repeat_bitwise": repeat,
                        "p_elements_moved": moved}
        print(f"[sgd] {name}: {json.dumps(shapes[name])}", flush=True)
        if not repeat or any(x for v in differ.values() for x in v) or moved == 0:
            fail(f"[sgd] {name}: the kernel is not its plain version bit for bit")
        del p, g, buf, runs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    leaves = [p.shape for p in net_factory("icl_unet", 1, CLASSES_2D, device="meta",
                                           patch_size=IMG_UNET, fuse_sspa_pair=True).parameters()]
    n_params = sum(math.prod(s) for s in leaves)
    ps = [draw(math.prod(s), 0, 0.05).view(s) for s in leaves]
    gs = [draw(math.prod(s), 0, 0.01).view(s) for s in leaves]
    bufs = [draw(math.prod(s), 0, 0.01).view(s) for s in leaves]

    def kernel_step():
        for i, (p, g, b) in enumerate(zip(ps, gs, bufs)):
            sg.sgd_bf16_update(p, g, b, lr, count, 0.9, 1e-4, 0, i)

    def plain_step():
        for i, (p, g, b) in enumerate(zip(ps, gs, bufs)):
            sg.sgd_bf16_plain(p, g, b, lr, count, 0.9, 1e-4, 0, i)

    global QUEUE_BEHIND_SLEEP
    ms = cuda_ms(kernel_step, reps=10)
    QUEUE_BEHIND_SLEEP = True
    try:
        device_ms = cuda_ms(kernel_step, reps=3)
    finally:
        QUEUE_BEHIND_SLEEP = False
    largest = max(range(len(ps)), key=lambda i: ps[i].numel())
    largest_ms = cuda_ms(lambda: sg.sgd_bf16_update(ps[largest], gs[largest], bufs[largest], lr,
                                                    count, 0.9, 1e-4, 0, largest), reps=10)
    plain_ms = cuda_ms(plain_step, reps=1, warmup=0)
    params = [torch.nn.Parameter(p) for p in ps]
    for p, g in zip(params, gs):
        p.grad = g
    fused = torch.optim.SGD(params, lr=0.01, momentum=0.9, weight_decay=1e-4, fused=True)
    library_ms = cuda_ms(fused.step, reps=10)
    del fused, params, ps, gs, bufs
    gc.collect()
    torch.cuda.empty_cache()
    f32 = [torch.nn.Parameter(torch.randn(s, generator=gen, device=DEVICE) * 0.05) for s in leaves]
    for p in f32:
        p.grad = torch.randn(p.shape, generator=gen, device=DEVICE) * 0.01
    opt32 = PolySGD(f32, 0.01, 30000)
    f32_ms = cuda_ms(opt32.step, reps=3)
    del opt32, f32
    gc.collect()
    torch.cuda.empty_cache()
    byte_ms = 10 * n_params / HBM_BYTES_PER_S * 1e3
    row = {"leaves": len(leaves), "parameters": n_params, "ms": ms, "device_ms": device_ms,
           "largest_leaf_ms": largest_ms, "largest_leaf_bound_ms": 10 * 268_435_456 / HBM_BYTES_PER_S * 1e3,
           "plain_ms": plain_ms, "library_ms": library_ms, "f32_polysgd_ms": f32_ms,
           **bound_fields(0.0, byte_ms), "max_abs_err": 0.0, "shapes": shapes,
           "seconds": time.perf_counter() - t0}
    print(f"[sgd] the flagship's {len(leaves)} leaves ({n_params} parameters, 10 bytes each): "
          f"{json.dumps({k: v for k, v in row.items() if k != 'shapes'})}", flush=True)
    return row


def phase_fast_cli(torch, wa, sg, slices, volumes) -> dict:
    """37: the fast configuration through the flagship CLI's `main` (the
    slices and volumes in memory, the first LABELED_SLICES_2D labeled):
    FAST_STEPS steps, a validation at the last (its dice in [0, 1]; after
    8 steps from random weights it may be 0, and then no best checkpoint is
    written), a checkpoint every FAST_CHECKPOINT; the window-attention launches (asserted: none) and
    the SR launches: the first step runs eagerly and the capture records
    the step once, so the wrapper counts 2 x 300 launches over the run and
    every replayed step runs the 300 the capture recorded (asserted)."""
    from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D as cli
    from icl_tpu_torch.train.steps import METRIC_KEYS

    trainers = []

    class Spy(cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

    saved = {"patients_to_slices": cli.patients_to_slices, "Trainer": cli.Trainer}
    cli.patients_to_slices = lambda root, num: LABELED_SLICES_2D
    cli.Trainer = Spy
    sg.reset_launch_counts()
    torch.manual_seed(0)
    try:
        run = run_cli(torch, wa, cli, ["--root_path", "in-memory-ACDC", "--exp", "ACDC_chip_smoke/Fast",
                                       "--num_tries", "fast", "--max_iterations", str(FAST_STEPS),
                                       "--val_interval", str(FAST_STEPS), "--checkpoint_interval",
                                       str(FAST_CHECKPOINT)] + FAST_ARGV,
                      "ACDCDataset", InMemoryDataset(slices, volumes), "[fast]", METRIC_KEYS, FAST_STEPS,
                      need_best=False)
    finally:
        for attr, value in saved.items():
            setattr(cli, attr, value)
    trainer = trainers[-1]
    leaves = len(trainer.optimizer.params)
    launches = sg.sgd_bf16_update.launches
    saves = [(s["iteration"], s["bytes"]) for s in run["saves"]]
    print(f"[fast] SR launches over the run {launches} (the eager first step and the capture, "
          f"{leaves} leaves each); recorded in the graph, run by each of its {trainer.replays} "
          f"replays: {trainer.graph_launches}; state saves (iteration, bytes) {saves}", flush=True)
    no_attention("[fast]", run["run_launches"])
    if launches != 2 * leaves or trainer.graph_launches["sgd_bf16"] != leaves \
            or trainer.replays != FAST_STEPS - 1 or any(trainer.graph_launches[k]
                                                        for k in ("window_attention",
                                                                  "window_attention_bwd")):
        fail("[fast] the SR launches are not one per leaf per step")
    return {**run, "leaves": leaves, "launches": launches, "per_replay": trainer.graph_launches,
            "replays": trainer.replays, "state_bytes": saves[-1][1]}


def graph_vs_eager(torch, wa, tag: str, trainer, batches: list, deterministic: bool) -> dict:
    """From one state S0 (host copy) of `trainer` (cfg.scan_steps > 1):
    A, GRAPH_STEPS eager steps; a repeat of A; the graph's first step (eager
    on a side stream, then the capture) from S0; then B, GRAPH_STEPS
    replays from S0. The flat states after A, its repeat and B, every step's
    metrics, and s/step eager against replayed (4 more of each from where B
    ended, in turns); the window-attention launches of the graph's first
    step (its eager run and the capture). `deterministic` runs with cuDNN's
    deterministic algorithms."""
    from icl_tpu_torch.utils.checkpoint import host_copy

    dev = [trainer.to_device(b) for b in batches]
    s0 = host_copy(trainer.train_state())
    torch.backends.cudnn.deterministic = deterministic
    try:
        def params():
            return {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}

        def steps(step):
            """Every step's metrics and the parameters after the first."""
            trainer.load_train_state(s0)
            vecs, after_first = [], None
            for i, x in enumerate(dev):
                vecs.append(step(x))
                if i == 0:
                    after_first = params()
            torch.cuda.synchronize()
            return flat(host_copy(trainer.train_state())), torch.stack(vecs).cpu(), after_first

        a, a_metrics, a1 = steps(trainer._stacked_step)
        again, again_metrics, again1 = steps(trainer._stacked_step)
        trainer.load_train_state(s0)
        wa.reset_launch_counts()
        trainer.graph_step(dev[0])
        first_step = launches_now(wa)
        b, b_metrics, b1 = steps(trainer.graph_step)

        def run(step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in dev:
                step(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / len(dev)

        times = {"eager": [], "replayed": []}
        for kind in ("eager", "replayed", "replayed", "eager"):
            times[kind].append(run(trainer._stacked_step if kind == "eager" else trainer.graph_step))
    finally:
        torch.backends.cudnn.deterministic = False
    differ = lambda x: sorted(k for k in a if not torch.equal(a[k], x[k]))
    out = {"s0": {n: s0["model"][n].cpu() for n, _ in trainer.model.named_parameters()},
           "first": {"a": a1, "b": b1, "again": again1}, "differ_b": differ(b), "differ_again": differ(again),
           "metrics_equal": torch.equal(a_metrics, b_metrics),
           "again_metrics_equal": torch.equal(a_metrics, again_metrics), "times": times,
           "graph_launches": dict(trainer.graph_launches), "first_step": first_step}
    print(f"{tag} {GRAPH_STEPS} replayed steps vs {GRAPH_STEPS} eager from one state (cuDNN "
          f"deterministic {deterministic}): {len(out['differ_b'])} of {len(a)} tensors differ, "
          f"metrics equal {out['metrics_equal']}; an eager repeat: {len(out['differ_again'])} "
          f"differ, metrics equal {out['again_metrics_equal']}; s/step eager {times['eager']} "
          f"replayed {times['replayed']}; launches recorded in the graph {out['graph_launches']}",
          flush=True)
    return out


def upsample_backward_repeats(torch) -> bool:
    """Whether the backward of the U-Net decoder's align-corners bilinear
    upsample (F.interpolate, here at its largest shape: [16, 16, 128,
    128] to 256^2) is bitwise equal across two runs on the card (its CUDA
    kernel adds with atomics)."""
    import torch.nn.functional as F

    x = torch.randn(16, 16, 128, 128, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(1),
                    requires_grad=True)
    g = torch.randn(16, 16, 256, 256, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(2))
    grads = []
    for _ in range(2):
        x.grad = None
        F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True).backward(g)
        grads.append(x.grad.clone())
    return torch.equal(*grads)


def phase_graph_vs_eager(torch, wa, slices) -> dict:
    """38: graph replay against eager steps. The flagship's fast
    configuration and the supervised Swin-UNet (224^2, window 7, batch 16,
    f32: both window-attention kernels in the graph, their launches per
    replayed step asserted: 8 no-mask + 6 mask, forward and backward), each
    by `graph_vs_eager` under cuDNN's deterministic algorithms: a replayed
    step must equal the eager one bit for bit wherever an eager repeat is
    bitwise; where the card's own repeat is not, the first replayed step is
    held against the first eager step by the rule of phase 18 with the
    eager repeat as control and witness (the rule "phase 18, control and
    witness = an eager repeat": after one step the card's differences are
    f32 rounding, which the bf16 state's rounding may move by one ulp;
    after four they compound). Then s/step eager against
    replayed for both and for the AMOS bf16 ICL step (U-Net-ICL 3D, 16
    classes, recompute on)."""
    import gc

    from icl_tpu_torch.scripts.profile_train_step import setup
    from icl_tpu_torch.train.trainer import Trainer

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"upsample_backward_bitwise": upsample_backward_repeats(torch)}
    print(f"[graph] the U-Net decoder's upsample backward twice on the card: bitwise "
          f"{out['upsample_backward_bitwise']}", flush=True)
    cfg = fast_config("graph", 100)
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    fast = graph_vs_eager(torch, wa, "[graph-fast]", trainer, fast_batches(torch, slices, cfg, GRAPH_STEPS),
                          deterministic=True)
    if fast["graph_launches"]["sgd_bf16"] != len(trainer.optimizer.params):
        fail("[graph-fast] the graph does not hold one SR launch per leaf")
    if fast["differ_b"] or not fast["metrics_equal"]:
        if not fast["differ_again"]:
            fail("[graph-fast] the replayed steps differ from the eager ones, which repeat bitwise")
        first = fast["first"]
        step_agreement(torch, "[graph-fast]", "the first replayed step vs the first eager step (rule: "
                       "phase 18, control and witness = an eager repeat)", fast["s0"],
                       {"test": ({}, first["b"]), "reference": ({}, first["a"]),
                        "control": ({}, first["again"]), "witness": ({}, first["again"])})
    out["fast"] = {k: fast[k] for k in ("differ_b", "differ_again", "metrics_equal", "times",
                                        "graph_launches")}
    del trainer, fast
    release()

    cfg, make_batches, _ = setup("swinunet", "float32")
    cfg.scan_steps = GRAPH_STEPS
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    stream = make_batches()
    swin = graph_vs_eager(torch, wa, "[graph-swin]", trainer, [next(stream) for _ in range(GRAPH_STEPS)],
                          deterministic=True)
    per_step = sum(SWIN_SUP_PER_STEP.values())
    if swin["graph_launches"]["window_attention"] != per_step \
            or swin["graph_launches"]["window_attention_bwd"] != per_step:
        fail(f"[graph-swin] the graph holds {swin['graph_launches']}, want {per_step} + {per_step}")
    if swin["differ_b"] or not swin["metrics_equal"]:
        fail(f"[graph-swin] the replayed steps differ from the eager ones: {swin['differ_b'][:8]}")
    out["swin"] = {k: swin[k] for k in ("differ_b", "differ_again", "metrics_equal", "times",
                                        "graph_launches")}
    out["swin_first_step"] = swin["first_step"]
    want = {m: 2 * SWIN_SUP_PER_STEP.get(m, 0) for m in ("none", "region", "mask")}
    if swin["first_step"]["fwd"] != want or swin["first_step"]["bwd"] != want:
        fail(f"[graph-swin] the eager first step and the capture launched {swin['first_step']}, "
             f"want {want} each way")
    del trainer, swin
    release()

    cfg, make_batches, _ = setup("unet_3D_icl", "bfloat16", "amos")
    cfg.scan_steps = GRAPH_STEPS
    torch.manual_seed(0)
    trainer = Trainer(cfg, device=DEVICE)
    stream = make_batches()
    amos = graph_vs_eager(torch, wa, "[graph-amos]", trainer, [next(stream) for _ in range(3)],
                          deterministic=False)
    out["amos"] = {k: amos[k] for k in ("differ_b", "differ_again", "metrics_equal", "times")}
    del trainer, amos
    release()
    return out


def log_lines(snapshot: str) -> list:
    """log.txt's per-step loss lines, without their time stamps."""
    with open(os.path.join(snapshot, "log.txt")) as f:
        return [line.split("]", 1)[-1] for line in f if "iteration" in line and "loss" in line]


def phase_dispatch_and_resume(torch, slices) -> dict:
    """39: under cuDNN's deterministic algorithms, (a) `fit` of the
    supervised Swin-UNet (224^2, window 7, batch 16, f32) with scan_steps 2
    at dispatch_depth 2 against depth 1: the parameters bit for bit and
    log.txt's loss lines equal; (b) the bf16 train state resumed, 4 + 4
    steps against 8 (scan_steps 4: the 8-step run replays steps 5-8, the
    resumed one runs step 5 eagerly): on the supervised Swin-UNet bit for
    bit; on the flagship's fast configuration bit for bit where an
    8-step repeat is, else by the rule of phase 38."""
    import gc

    from icl_tpu_torch.scripts.profile_train_step import setup
    from icl_tpu_torch.train.trainer import Trainer
    from icl_tpu_torch.utils import checkpoint as ckpt
    from icl_tpu_torch.utils.checkpoint import host_copy

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def swin_cfg(tries, **kw):
        cfg, make_batches, _ = setup("swinunet", "float32")
        cfg.experiments_dir, cfg.exp, cfg.num_tries = EXPERIMENTS, "ACDC_chip_smoke/Dispatch", tries
        cfg.max_iterations, cfg.val_interval = 8, 0
        for k, v in kw.items():
            setattr(cfg, k, v)
        return cfg, make_batches

    def fit(cfg, batches, restore=None):
        """A fresh Trainer from seed 0 through `fit` (after `restore_state`
        from another snapshot's step file, when given): (flat state, result,
        the parameters before the fit)."""
        torch.manual_seed(0)
        trainer = Trainer(cfg, device=DEVICE)
        if restore is not None:
            trainer.load_train_state(ckpt.load_train_state(*restore, device=DEVICE))
        start = {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}
        result = trainer.fit(batches)
        state = flat(host_copy(trainer.train_state()))
        del trainer
        release()
        return state, result, start

    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for depth in (1, 2):
            cfg, make_batches = swin_cfg(f"depth{depth}", scan_steps=2, dispatch_depth=depth)
            stream = make_batches()
            state, result, _ = fit(cfg, [next(stream) for _ in range(8)])
            drop_states(result)
            runs[depth] = (state, log_lines(cfg.snapshot_path))
        differ = sorted(k for k in runs[1][0] if not torch.equal(runs[1][0][k], runs[2][0][k]))
        print(f"[dispatch] Swin-UNet, 8 steps in groups of 2, depth 2 vs 1: {len(differ)} of "
              f"{len(runs[1][0])} tensors differ; log lines {len(runs[1][1])} and {len(runs[2][1])}, "
              f"equal {runs[1][1] == runs[2][1]}", flush=True)
        if differ or runs[1][1] != runs[2][1] or len(runs[1][1]) != 8:
            fail("[dispatch] dispatch_depth 2 moved the parameters or the logs")
        out["depth"] = {"differ": differ, "log_lines": len(runs[1][1])}

        for tag, kind in (("[resume-swin]", "swin"), ("[resume-fast]", "fast")):
            if kind == "swin":
                cfg_a, make_batches = swin_cfg("resumeA", state_dtype="bfloat16", scan_steps=4,
                                               checkpoint_interval=4)
                stream = make_batches()
                batches = [next(stream) for _ in range(8)]
                cfg_b, _ = swin_cfg("resumeB", state_dtype="bfloat16", scan_steps=4,
                                    checkpoint_interval=4)
                cfg_r, _ = swin_cfg("resumeR", state_dtype="bfloat16", scan_steps=4)
            else:
                cfg_a = fast_config("resumeA", 8, checkpoint_interval=4)
                batches = fast_batches(torch, slices, cfg_a, 8)
                cfg_b = fast_config("resumeB", 8, checkpoint_interval=4)
                cfg_r = fast_config("resumeR", 8)
            a, result_a, initial = fit(cfg_a, batches)
            # B: a fresh trainer restores A's step-4 file and takes batches 5-8
            step4 = [s for s in result_a["saves"] if s["iteration"] == 4]
            b, result_b, _ = fit(cfg_b, batches[4:], restore=(cfg_a.snapshot_path, "step_00000004"))
            if not step4 or [r["iteration"] for r in result_b["log"]] != [5, 6, 7, 8]:
                fail(f"{tag} the resumed run did not take steps 5-8")
            differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
            print(f"{tag} bf16 state {step4[0]['bytes'] / 1e9:.3f} GB at step 4; 4 + restore + 4 vs 8: "
                  f"{len(differ)} of {len(a)} tensors differ {differ[:4]}", flush=True)
            out[kind] = {"differ": len(differ), "tensors": len(a), "state_bytes": step4[0]["bytes"]}
            drop_states(result_a)
            drop_states(result_b)
            if not differ:
                continue
            if kind == "swin":
                fail(f"{tag} the resumed bf16 run is not the uninterrupted one bit for bit")
            r, result_r, _ = fit(cfg_r, batches)
            drop_states(result_r)
            differ_r = sorted(k for k in a if not torch.equal(a[k], r[k]))
            print(f"{tag} a repeat of the 8 steps: {len(differ_r)} tensors differ", flush=True)
            if not differ_r:
                fail(f"{tag} the resumed run differs where a repeat of the run does not")
            trained = lambda st: ({}, {n: st[f"model/{n}"] for n in initial})
            step_agreement(torch, tag, "4 + restore + 4 vs 8 bf16 steps (rule: phase 18, "
                           "control and witness = a repeat of the 8 steps)", initial,
                           {"test": trained(b), "reference": trained(a), "control": trained(r),
                            "witness": trained(r)})
            out[kind]["differ_repeat"] = len(differ_r)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def phase_device_augment(torch, slices) -> dict:
    """40: `augment_batch` on the card against the same call on the CPU,
    for the same bank and draws: every angle in [-20, 20), every rot90/flip
    branch and the identity, at the patch (256^2) and zoomed to 224^2; 0
    differing pixels in images and labels. Then the time of one flagship
    batch (16 slices) on the card."""
    import numpy as np

    from icl_tpu_torch.data.device_augment import NONE, ROT_FLIP, ROTATE, augment_batch
    from icl_tpu_torch.data.device_bank import build_acdc_bank

    angles = list(range(-20, 20))
    flips = [(k, axis) for k in range(4) for axis in (0, 1)]
    n = len(angles) + len(flips) + 1
    params = {"branch": np.array([ROTATE] * len(angles) + [ROT_FLIP] * len(flips) + [NONE]),
              "k": np.array([0] * len(angles) + [k for k, _ in flips] + [0]),
              "axis": np.array([0] * len(angles) + [a for _, a in flips] + [0]),
              "angle": np.array(angles + [0] * len(flips) + [0])}
    idx = np.arange(n) % len(slices)
    out = {}
    for device in ("cpu", DEVICE):
        image_bank, label_bank = build_acdc_bank(slices, IMG_UNET, device)
        ix = torch.as_tensor(idx, device=device)
        prm = {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in params.items()}
        for size in (IMG_UNET, 224):
            img, lab = augment_batch(image_bank[ix], label_bank[ix], prm, size)
            out[(device, size)] = (img.cpu(), lab.cpu())
    differ = {size: (int((out[("cpu", size)][0] != out[(DEVICE, size)][0]).sum()),
                     int((out[("cpu", size)][1] != out[(DEVICE, size)][1]).sum())) for size in (IMG_UNET, 224)}
    image_bank, label_bank = build_acdc_bank(slices, IMG_UNET, DEVICE)
    ix = torch.arange(BATCH_2D, device=DEVICE)
    prm = {k: torch.as_tensor(v[:BATCH_2D], dtype=torch.int64, device=DEVICE) for k, v in params.items()}
    ms = cuda_ms(lambda: augment_batch(image_bank[ix], label_bank[ix], prm, IMG_UNET), reps=20)
    print(f"[augment] {n} samples ({len(angles)} angles, {len(flips)} rot90/flip, identity), card vs "
          f"CPU differing (image, label) pixels by output size {differ}; one batch of {BATCH_2D} at "
          f"{IMG_UNET}^2 on the card: {ms:.4f} ms", flush=True)
    if any(a or b for a, b in differ.values()):
        fail("[augment] the card's device augment differs from the CPU's")
    return {"differ": differ, "batch_ms": ms}


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from icl_tpu_torch.eval.infer3d import _grid_starts, make_patch_predictor, sliding_window_predict
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swinunetr import WindowAttention3D
    from icl_tpu_torch.ops import sgd_bf16 as sg
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.ops.build import build_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    kind = torch.cuda.get_device_name(0)
    print(f"[card] nvidia-smi: {card} | torch: {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. the builds, one nvcc per source, started together
    t0 = time.perf_counter()
    sources = ("window_attention", "window_attention_bwd", "sgd_bf16")
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(build_library, sources))
    build_s = time.perf_counter() - t0
    for source, (lib_path, log) in zip(sources, builds[:2]):
        usage = ptxas_usage(log, f"{source}_kernel") if log else "already built"
        spills = sorted(n for n, (_, spill) in usage.items() if spill) if log else "not read"
        print(f"[build] {lib_path}: registers and spill stores (bytes) per instance {json.dumps(usage)}; "
              f"instances that spill: {spills or 'none'}", flush=True)
    sgd_log = [line.strip() for line in builds[2][1].splitlines() if "Used" in line or "spill" in line]
    print(f"[build] {builds[2][0]}: {sgd_log or 'already built'}", flush=True)
    print(f"[build] the three libraries in {build_s:.2f} s", flush=True)
    for what, query, too_large in (("window_attention", wa._fwd_geometry, 1000),
                                   ("window_attention_bwd", wa._bwd_geometry, 450)):
        geometry = {f"N{n} D{d}": dict(zip(("warps", "smem_bytes", "ctas_per_sm"),
                                           query(n, d, False, True, False, 0)))
                    for n, d in ((343, 16), (216, 16), (144, 32), (49, 32), (4, 32))}
        print(f"[build] {what} f32 MASK geometry per CTA: {json.dumps(geometry)}", flush=True)
        try:
            query(too_large, HEAD_DIM_2D, False, False, False, 0)
            fail(f"{what}'s geometry took a window of {too_large} tokens at head dim 32")
        except ValueError as e:
            print(f"[build] refused as it should be: {e}", flush=True)
    z = [torch.zeros(1, 1, 8, HEAD_DIM, device=DEVICE) for _ in range(4)]
    wa.window_attention(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), scale=1.0)
    wa.window_attention_bwd(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), None, z[3], scale=1.0)
    torch.cuda.synchronize()

    # 3 + 4. the forward kernel against its plain version, and times
    per_shape = phase_kernel_3d(torch, F, wa)

    # 5. the main path
    model = net_factory("swinunetr_icl", 1, 2, device=DEVICE, feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(0), inference=True).eval()
    probs_fn = make_patch_predictor(model)
    volume = np.random.default_rng(0).standard_normal(VOLUME).astype(np.float32)
    args = (probs_fn, volume, 2, (PATCH,) * 3, STRIDE, STRIDE, SW_BATCH)
    sliding_window_predict(*args, device=DEVICE)  # warm-up: cuDNN plans, allocator
    wa.reset_launch_counts()
    t0 = time.perf_counter()
    labels = sliding_window_predict(*args, device=DEVICE)
    torch.cuda.synchronize()
    volume_s = time.perf_counter() - t0
    launches = dict(wa.window_attention.launches_by_mode)
    total = wa.window_attention.launches
    print(f"[path] sliding window {VOLUME}, fs{FEATURE_SIZE}, {PATCH}^3 patches, stride {STRIDE}, "
          f"sw_batch {SW_BATCH}: {volume_s:.3f} s/volume; "
          f"launches {total} {launches}; labels {np.bincount(labels.ravel(), minlength=2).tolist()}",
          flush=True)
    if labels.shape != volume.shape or labels.max() > 1:
        fail(f"label map {labels.shape} max {labels.max()}")
    n_forwards = math.ceil(math.prod(len(_grid_starts(d, PATCH, STRIDE)) for d in VOLUME) / SW_BATCH)
    expected = {mode: n_forwards * sum(PER_FORWARD[mode].values()) for mode in ("none", "region")}
    expected["mask"] = 0
    if total != sum(expected.values()) or launches != expected:
        fail(f"expected {sum(expected.values())} launches {expected}, got {total} {launches}")

    # 6. one sw_batch forward against the plain attention, same weights
    x = torch.from_numpy(volume[:PATCH, :PATCH, :PATCH]).to(DEVICE)
    x = torch.stack([x, x.flip(0), x.flip(1), x.flip(2)])[:, None]
    probs = probs_fn(x)
    attns = [m for m in model.modules() if isinstance(m, WindowAttention3D)]
    for m in attns:
        m.attention = wa.window_attention_plain
    probs_plain = probs_fn(x)
    for m in attns:
        m.attention = wa.window_attention
    probs_err = float((probs - probs_plain).abs().max())
    print(f"[path] one sw_batch forward, kernel vs plain attention: probs max abs err {probs_err:.3e} "
          f"(tolerance {PROBS_ATOL})", flush=True)
    if not torch.isfinite(probs).all() or probs_err > PROBS_ATOL:
        fail("forward through the kernel disagrees with the plain attention")

    del model, probs_fn, probs, probs_plain, x
    torch.cuda.empty_cache()

    # 7 + 8. the backward kernel
    bwd_rows = phase_backward_kernel(torch, F, wa)

    # 9 - 11. the training path, the step against plain attention, train -> eval
    from icl_tpu_torch.data.synth import synthetic_brats_cases

    shutil.rmtree(EXPERIMENTS, ignore_errors=True)
    cases = synthetic_brats_cases(4, CASE_SIZE, seed=0)
    held_out = synthetic_brats_cases(1, CASE_SIZE, seed=1)
    training = phase_training(torch, wa, cases, held_out)
    phase_step_parity(torch, wa, cases)
    phase_train_to_eval(torch, held_out, training)

    # 12 - 16. this slice: the 2D kernels, the Swin-UNet-ICL training path,
    # its step against plain attention, train -> eval
    from icl_tpu_torch.data.synth import synthetic_acdc

    fwd_rows_2d, bwd_rows_2d = phase_kernels_2d(torch, F, wa)
    slices, volumes = synthetic_acdc(SLICES_2D, VOLUMES_2D, SLICE_SIZE_2D, VOL_DEPTH_2D, CLASSES_2D,
                                     seed=0)
    training_2d = phase_training_2d(torch, wa, slices, volumes)
    phase_step_parity_2d(torch, wa, slices)
    phase_train_to_eval_2d(torch, volumes, training_2d)

    # 17 - 20. this slice: U-Net-ICL training on the same data, its step on
    # the card against the CPU, the fused sspa pair, train -> eval
    training_unet = phase_training_unet(torch, wa, slices, volumes)
    phase_unet_device_vs_cpu(torch, slices)
    phase_unet_fused_pair(torch, slices)
    phase_train_to_eval_unet(torch, volumes, training_unet)

    # 21 - 27. this slice: U-Net-ICL 3D on BraTS, its step on the card
    # against the CPU, the supervised U-Net 3D, train -> eval; the AMOS
    # CLIs and train -> eval
    training_unet3d = phase_training_unet3d(torch, wa, cases, held_out)
    phase_unet3d_device_vs_cpu(torch, cases)
    supervised_unet3d = phase_supervised_unet3d(torch, wa, cases)
    phase_train_to_eval_unet3d(torch, held_out, training_unet3d)
    amos_icl, amos_sup = phase_amos(torch, wa)

    # 28 - 32. this slice: the kernels at the supervised paths' shapes, the
    # three supervised CLIs with train -> eval, and the resume
    sup_rows = phase_kernels_supervised(torch, F, wa)
    sup_unet = phase_supervised_unet_2d(torch, wa, slices, volumes)
    sup_swinunet = phase_supervised_swinunet_2d(torch, wa, slices, volumes)
    sup_swinunetr = phase_supervised_swinunetr_3d(torch, wa, cases, held_out)
    torch.backends.cudnn.deterministic = True
    try:
        resume = phase_resume(torch, slices)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"[summary] resume: {json.dumps(resume)}", flush=True)

    # 33 - 35. this slice: FixMatch-CTA through its CLI at the JAX defaults,
    # its step on the card against the CPU, the resume of its saved run
    t0 = time.perf_counter()
    cta = phase_fixmatch_cta(torch, wa, slices, volumes)
    phase_fixmatch_device_vs_cpu(torch, slices)
    cta_resume = phase_fixmatch_resume(torch, wa, slices, volumes, cta)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    print(f"[summary] FixMatch-CTA phases 33-35 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'s_per_step': {k: cta[k]['s_per_step'] for k in ('lag1', 'lag0')}, 'peak_gib': cta['lag1']['peak_bytes'] / 2**30, 'batch_s': cta['batch_s'], 'step_s': cta['step_s'], 'moved': cta['moved'], 'resume': cta_resume})}",
          flush=True)

    # 36 - 40. this slice: the flagship's fast configuration: the SR kernel
    # and the card's kernel tests, the fast CLI, graph replay against eager,
    # the dispatch window and the bf16 resume, the device augment
    t0 = time.perf_counter()
    sgd_row = phase_sgd_kernel(torch, sg)
    card_tests = run_card_tests()
    fast = phase_fast_cli(torch, wa, sg, slices, volumes)
    graph = phase_graph_vs_eager(torch, wa, slices)
    dispatch = phase_dispatch_and_resume(torch, slices)
    augment = phase_device_augment(torch, slices)
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke"), ignore_errors=True)
    print(f"[summary] fast configuration phases 36-40 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({'card_tests': card_tests, 'fast_peak_gib': fast['peak_bytes'] / 2**30, 'fast_state_bytes': fast['state_bytes'], 'graph': {k: graph[k] for k in ('fast', 'swin', 'amos')}, 'upsample_backward_bitwise': graph['upsample_backward_bitwise'], 'dispatch': dispatch, 'augment': augment})}",
          flush=True)

    # The kernels line, one entry per kernel and mode. Times are sums over
    # the shapes of a unit of work, each f32 launch time times its launches
    # there: for no-mask and mask one Swin-UNet-ICL training step at 384^2
    # (two passes at batch 8; this slice's path, phases 12-13), for region
    # one SwinUNETR inference forward (forward, phase 4) or training step
    # (backward, phase 8); `paths` holds the other units. `launches`: the
    # training run of the same path (3 steps and a validation, phases 14 or
    # 9), the other paths' runs beside it in `launches_by_path` (the U-Net
    # paths of phases 17, 21, 23, 25, 26, 29 and 33 launch none).
    def totals(rows, weights):
        by_stage = {r["stage"]: r for r in rows}
        tot = {key: sum(by_stage[st][key] * n for st, n in weights.items())
               for key in ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")}
        return {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
                **bound_fields(tot["flop_ms"], tot["byte_ms"])}

    def timed(rows, mode):
        return [r for r in rows if r["mode"] == mode and "ms" in r]

    step_2d = {m: {st[0]: 2 * st[4][m] for st in STAGES_2D if m in st[4]} for m in PER_FORWARD_2D}
    units = {
        "fwd": {"region": totals(timed(per_shape, "region"), PER_FORWARD["region"]),
                "none": totals(timed(fwd_rows_2d, "none"), step_2d["none"]),
                "mask": totals(timed(fwd_rows_2d, "mask"), step_2d["mask"])},
        "bwd": {"region": totals(timed(bwd_rows, "region"), BWD_PER_STEP_BY_STAGE["region"]),
                "none": totals(timed(bwd_rows_2d, "none"), step_2d["none"]),
                "mask": totals(timed(bwd_rows_2d, "mask"), step_2d["mask"])},
    }
    ref_224 = {m: {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms")}
               for m in PER_FORWARD_2D for r in timed(fwd_rows_2d, m) if r["stage"] == REF_STAGE_2D[0]}
    sup_2d = {m: {st[0]: st[4][m] for st in STAGES_SWIN_SUP if m in st[4]} for m in PER_FORWARD_SWIN_SUP}
    sup_3d_fwd = {m: {st: 2 * n for st, n in PER_FORWARD[m].items()} for m in ("none", "region")}
    paths = {
        "fwd": {"none": {"swinunetr_inference_forward": totals(timed(per_shape, "none"), PER_FORWARD["none"]),
                         "swinunet2d_224_w7_stage1_launch": ref_224["none"],
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["fwd2d"] if r["mode"] == "none"], sup_2d["none"]),
                         "swinunetr_supervised_step_bf16": totals(
                             [r for r in sup_rows["fwd3d"] if r["mode"] == "none"], sup_3d_fwd["none"])},
                "mask": {"swinunet2d_224_w7_stage1_launch": ref_224["mask"],
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["fwd2d"] if r["mode"] == "mask"], sup_2d["mask"])},
                "region": {"swinunetr_supervised_step_bf16": totals(
                    [r for r in sup_rows["fwd3d"] if r["mode"] == "region"], sup_3d_fwd["region"])}},
        "bwd": {"none": {"swinunetr_training_step": totals(timed(bwd_rows, "none"),
                                                           BWD_PER_STEP_BY_STAGE["none"]),
                         "swinunet2d_supervised_step": totals(
                             [r for r in sup_rows["bwd2d"] if r["mode"] == "none"], sup_2d["none"]),
                         "swinunetr_supervised_step_bf16": totals(
                             [r for r in sup_rows["bwd3d"] if r["mode"] == "none"], PER_FORWARD["none"])},
                "mask": {"swinunet2d_supervised_step": totals(
                    [r for r in sup_rows["bwd2d"] if r["mode"] == "mask"], sup_2d["mask"])},
                "region": {"swinunetr_supervised_step_bf16": totals(
                    [r for r in sup_rows["bwd3d"] if r["mode"] == "region"], PER_FORWARD["region"])}},
    }
    per = {"region": {"fwd": "SwinUNETR inference forward", "bwd": "SwinUNETR-ICL training step"},
           "none": "Swin-UNet-ICL training step", "mask": "Swin-UNet-ICL training step"}
    kernels = []
    for direction, source, rows_3d, rows_2d in (("fwd", "window_attention", per_shape, fwd_rows_2d),
                                                ("bwd", "window_attention_bwd", bwd_rows, bwd_rows_2d)):
        for mode in ("none", "region", "mask"):
            by_path = {"training_3d": training["path_launches"][direction][mode],
                       "training_2d": training_2d["path_launches"][direction][mode],
                       "training_unet_2d": training_unet["path_launches"][direction][mode],
                       "training_unet_3d_brats": training_unet3d["path_launches"][direction][mode],
                       "training_unet_3d_brats_supervised":
                           supervised_unet3d["path_launches"][direction][mode],
                       "training_unet_3d_amos": amos_icl["path_launches"][direction][mode],
                       "training_unet_3d_amos_supervised":
                           amos_sup["path_launches"][direction][mode],
                       "training_unet_2d_supervised": sup_unet["path_launches"][direction][mode],
                       "training_swinunet_2d_supervised":
                           sup_swinunet["path_launches"][direction][mode],
                       "training_swinunetr_3d_supervised":
                           sup_swinunetr["path_launches"][direction][mode],
                       "training_fixmatch_cta_2d": cta["path_launches"][direction][mode],
                       "training_fast_unet_2d": fast["run_launches"][direction][mode],
                       "graph_swinunet_2d_supervised_first_step":
                           graph["swin_first_step"][direction][mode]}
            if direction == "fwd":
                by_path["inference_3d"] = launches.get(mode, 0)
            errs = [r["max_abs_err"] for r in rows_3d + rows_2d if r["mode"] == mode
                    and (direction == "bwd" or r["dtype"] == "float32")]
            kernels.append({
                "name": f"{source}[{mode}]",
                "route": "cuda",
                "source": f"icl_tpu_torch/ops/csrc/{source}.cu",
                "replaces": REPLACES[mode] if direction == "fwd" else BWD_REPLACES,
                "launches": by_path["training_3d" if mode == "region" else "training_2d"],
                "launches_by_path": by_path,
                "max_abs_err": max(errs),
                **units[direction][mode],
                "per": per[mode][direction] if mode == "region" else per[mode],
                "paths": paths[direction].get(mode, {}),
            })
    kernels.append({
        "name": "sgd_bf16", "route": "cuda", "source": "icl_tpu_torch/ops/csrc/sgd_bf16.cu",
        "replaces": SGD_REPLACES, "launches": fast["launches"],
        "launches_per_replayed_step": fast["per_replay"]["sgd_bf16"], "replays": fast["replays"],
        "max_abs_err": sgd_row["max_abs_err"], "ms": sgd_row["ms"], "device_ms": sgd_row["device_ms"],
        "plain_ms": sgd_row["plain_ms"], "bound_ms": sgd_row["bound_ms"],
        "bound_by": sgd_row["bound_by"], "library_ms": sgd_row["library_ms"],
        "f32_polysgd_ms": sgd_row["f32_polysgd_ms"], "largest_leaf_ms": sgd_row["largest_leaf_ms"],
        "largest_leaf_bound_ms": sgd_row["largest_leaf_bound_ms"],
        "per": f"the flagship's SGD update, {sgd_row['leaves']} leaves, {sgd_row['parameters']} "
               "parameters; library_ms is torch.optim.SGD(fused=True) on the same bf16 tensors "
               "(round-to-nearest stores)"})
    print(f"[summary] chip_smoke.py: every phase passed in {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
