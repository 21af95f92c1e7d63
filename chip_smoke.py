#!/usr/bin/env python3
"""Chip smoke test of icl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. the builds of the window-attention CUDA kernels (forward and
     backward) from ops/csrc, one nvcc each, started together; each
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
then a `kernels` JSON line, the card line, and the result line. Exits
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
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPERIMENTS = os.path.join(ROOT, "build", "chip_smoke", "experiments")


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


def bound(B, H, N, D, mask_floats=0, backward=False):
    """(ms at the f32-accurate rate, ms at the memory rate). Forward: two N x N x D
    products per (window, head); q, k, v read and out written once, bias
    read once. Backward: five products; q, k, v, dO read and dq, dk, dv
    written once, bias read and dbias written once. The region ids [nW, N]
    or the dense mask [nW, N, N] (`mask_floats` values) read once."""
    products, tensors, bias_arrays = (5, 7, 2) if backward else (2, 4, 1)
    flops = 2 * products * B * H * N * N * D
    nbytes = (tensors * B * H * N * D + bias_arrays * H * N * N + mask_floats) * 4
    return flops / F32_ACCURATE_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


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
    bias (+ the dense mask [nW, N, N]) for q, k, v and the bias, timed on
    a retained graph."""
    B, H, N, D = q.shape
    nW = mask.shape[0] if mask is not None else B
    shape = (B // nW, nW, H, N, D) if mask is not None else (B, H, N, D)
    qs, ks, vs = (t.detach().view(shape).requires_grad_(True) for t in (q, k, v))
    mask_leaf = bias.detach().clone().requires_grad_(True)
    attn = mask_leaf if mask is None else mask_leaf[None] + mask[:, None]
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
    log16 = trainer.fit(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS,
                                            cfg16.patch_size, seed=cfg16.seed))["log"]
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


def inputs_2d(torch, stage, dtype, gen, kind):
    """q, k, v, bias and the mask of one Swin-UNet 2D attention shape at
    batch LABELED_2D: `kind` None (no mask), "shift" (the shifted block's
    mask) or "random" (a dense mask N(0, 3^2): the kernels take any)."""
    from icl_tpu_torch.models.swin2d import shifted_window_mask

    _, side, ws, heads, _ = stage
    nW, N = (side // ws) ** 2, ws * ws
    q, k, v = (torch.randn(LABELED_2D * nW, heads, N, HEAD_DIM_2D, device=DEVICE, generator=gen)
               .to(dtype) for _ in range(3))
    bias = torch.randn(heads, N, N, device=DEVICE, generator=gen)
    mask = None
    if kind == "shift":
        mask = torch.from_numpy(shifted_window_mask(side, side, ws, ws // 2)).to(DEVICE)
    elif kind == "random":
        mask = 3.0 * torch.randn(nW, N, N, device=DEVICE, generator=gen)
    return q, k, v, bias, mask


def phase_kernels_2d(torch, F, wa) -> tuple[list[dict], list[dict]]:
    """12 + 13: the forward and backward kernels at the 2D shapes (384^2,
    the reference's 224^2 stage 1 and a 2 x 2 window) against their plain
    versions; f32 times with the shift mask."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    scale = HEAD_DIM_2D ** -0.5
    fwd_rows, bwd_rows = [], []
    for stage in STAGES_2D + [REF_STAGE_2D, TINY_STAGE_2D]:
        for mode in stage[4]:
            for kind in ((None,) if mode == "none" else ("shift", "random")):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, bias, mask = inputs_2d(torch, stage, dtype, gen, kind)
                    B, H, N, D = q.shape
                    nW = mask.shape[0] if mask is not None else B
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
                    row = {"stage": stage[0], "mode": mode, "mask": kind,
                           "dtype": str(dtype).split(".")[-1], "shape": list(q.shape),
                           "nW": nW if mask is not None else None, "max_abs_err": float(err.max()),
                           "bitwise_repeat": torch.equal(got, again)}
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
                    fwd_rows.append(row)
                    print(f"[kernel2d] {json.dumps(row)}", flush=True)
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
                    bwd_rows.append(brow)
                    print(f"[bwd2d] {json.dumps(brow)}", flush=True)
                    del g, got, again, want
                del q, k, v, bias, mask
                torch.cuda.empty_cache()
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


def main() -> int:
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
    sources = ("window_attention", "window_attention_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(build_library, sources))
    build_s = time.perf_counter() - t0
    for source, (lib_path, log) in zip(sources, builds):
        usage = ptxas_usage(log, f"{source}_kernel") if log else "already built"
        spills = sorted(n for n, (_, spill) in usage.items() if spill) if log else "not read"
        print(f"[build] {lib_path}: registers and spill stores (bytes) per instance {json.dumps(usage)}; "
              f"instances that spill: {spills or 'none'}", flush=True)
    print(f"[build] both libraries in {build_s:.2f} s", flush=True)
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

    # The kernels line, one entry per kernel and mode. Times are sums over
    # the shapes of a unit of work, each f32 launch time times its launches
    # there: for no-mask and mask one Swin-UNet-ICL training step at 384^2
    # (two passes at batch 8; this slice's path, phases 12-13), for region
    # one SwinUNETR inference forward (forward, phase 4) or training step
    # (backward, phase 8); `paths` holds the other units. `launches`: the
    # training run of the same path (3 steps and a validation, phases 14 or
    # 9), the other paths' runs beside it in `launches_by_path`.
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
    paths = {
        "fwd": {"none": {"swinunetr_inference_forward": totals(timed(per_shape, "none"), PER_FORWARD["none"]),
                         "swinunet2d_224_w7_stage1_launch": ref_224["none"]},
                "mask": {"swinunet2d_224_w7_stage1_launch": ref_224["mask"]}},
        "bwd": {"none": {"swinunetr_training_step": totals(timed(bwd_rows, "none"),
                                                           BWD_PER_STEP_BY_STAGE["none"])}},
    }
    per = {"region": {"fwd": "SwinUNETR inference forward", "bwd": "SwinUNETR-ICL training step"},
           "none": "Swin-UNet-ICL training step", "mask": "Swin-UNet-ICL training step"}
    kernels = []
    for direction, source, rows_3d, rows_2d in (("fwd", "window_attention", per_shape, fwd_rows_2d),
                                                ("bwd", "window_attention_bwd", bwd_rows, bwd_rows_2d)):
        for mode in ("none", "region", "mask"):
            by_path = {"training_3d": training["path_launches"][direction][mode],
                       "training_2d": training_2d["path_launches"][direction][mode]}
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
