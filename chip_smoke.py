#!/usr/bin/env python3
"""Chip smoke test of icl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. the builds of the window-attention CUDA kernels (forward and
     backward) from ops/csrc, one nvcc each, started together;
  3. the kernel against its plain PyTorch version at the four shapes of
     one SwinUNETR fs48 sw_batch-4 forward at 96^3, f32 and bf16;
  4. times at those shapes: the kernel, the plain version, and
     F.scaled_dot_product_attention as the one PyTorch call that computes
     the same function, beside the kernel's bound;
  5. the main path: BraTS sliding-window inference with SwinUNETR fs48
     (1 channel, 2 classes, seeded init) on a seeded 160x160x128 volume,
     96^3 patches, stride 64, sw_batch 4: 8 patches in 2 forwards; the
     kernel launches are counted and must be 16 (5 no-mask + 3 region per
     forward);
  6. one sw_batch forward's probabilities against the same weights with
     the plain attention;
  7. the backward kernel against its plain version at the four attention
     shapes of one SwinUNETR-ICL training pass (batch 2 at 96^3), in both
     mask modes where the stage shifts, f32 and bf16, and bitwise equal
     across two runs;
  8. times at those shapes: the backward kernel, the plain backward, and
     the backward of F.scaled_dot_product_attention (q, k, v and the mask),
     beside the bound;
  9. the training path: SwinUNETR-ICL fs48 at 96^3, batch 4 (2 labeled),
     f32 with TF32 off, recompute on, through Trainer.fit for 3 steps on
     seeded in-memory 128^3 cases, with a validation at step 3 on one
     held-out case; s/step after the warm-up step, peak memory, every loss
     term, and the kernel launches per step (asserted: 16 backward, 10
     no-mask + 6 region; 32 forward, the 16 of the two passes and their
     recompute); then one step under bfloat16 autocast;
 10. one training step through the kernels against the same step with the
     plain attention (same weights and batch, f32, drop path off): every
     loss term, and the updated bias tables and qkv weights of stages 1
     and 4;
 11. train -> eval: the stripped best checkpoint loads strictly through
     the eval CLI's loader and gives the trainer's validation dice;
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
F32_PEAK_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
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
            "region": "icl_tpu/ops/pallas/window_attention.py:60"}
BWD_REPLACES = "icl_tpu/ops/pallas/window_attention.py:290"

# The training path: SwinUNETR-ICL fs48 at 96^3, batch 4 of which 2
# labeled; each backbone pass runs batch 2, so the attention shapes are
# those of STAGES at batch 2.
TRAIN_BATCH, LABELED_BS, TRAIN_STEPS, CASE_SIZE = 4, 2, 3, 128
# kernel launches per training step: two backbone passes, each with
# PER_FORWARD's calls, and recompute runs every Swin block's forward again
BWD_PER_STEP = {m: 2 * sum(PER_FORWARD[m].values()) for m in ("none", "region")}
FWD_PER_STEP = {m: 2 * n for m, n in BWD_PER_STEP.items()}
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPERIMENTS = os.path.join(ROOT, "build", "chip_smoke", "experiments")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def bound(B, H, N, D, nW, masked, backward=False):
    """(ms at the f32 rate, ms at the memory rate). Forward: two N x N x D
    products per (window, head); q, k, v read and out written once, bias
    read once. Backward: five products; q, k, v, dO read and dq, dk, dv
    written once, bias read and dbias written once. Region ids read once."""
    products, tensors, bias_arrays = (5, 7, 2) if backward else (2, 4, 1)
    flops = 2 * products * B * H * N * N * D
    nbytes = (tensors * B * H * N * D + bias_arrays * H * N * N + (nW * N if masked else 0)) * 4
    return flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def sdpa_backward_ms(torch, F, wa, q, k, v, bias, ids, g, scale) -> float:
    """The backward of F.scaled_dot_product_attention with attn_mask =
    bias (+ mask) for q, k, v and the mask, timed on a retained graph."""
    B, H, N, D = q.shape
    nW = ids.shape[0] if ids is not None else B
    shape = (B // nW, nW, H, N, D) if ids is not None else (B, H, N, D)
    qs, ks, vs = (t.detach().view(shape).requires_grad_(True) for t in (q, k, v))
    mask_leaf = bias.detach().clone().requires_grad_(True)
    mask = mask_leaf if ids is None else mask_leaf[None] + wa.mask_from_region_ids(ids)[:, None]
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale)
    gout = g.view(shape)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs, mask_leaf), gout, retain_graph=True))


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
                    flop_ms, byte_ms = bound(B, H, N, D, ids.shape[0] if ids is not None else B,
                                             ids is not None, backward=True)
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain_bwd(
                            q, k, v, bias, ids, g, scale=scale), reps=3),
                        library_ms=sdpa_backward_ms(torch, F, wa, q, k, v, bias, ids, g, scale),
                        flop_ms=flop_ms, byte_ms=byte_ms, bound_ms=max(flop_ms, byte_ms),
                        bound_by="operations" if flop_ms >= byte_ms else "bytes",
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
        if per_steps[kind] != {m: TRAIN_STEPS * n for m, n in want[kind].items()}:
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
    """10: one f32 step through the kernels against the same step (same
    weights, same batch, drop path off) with the plain attention, beside
    a control: the kernel step on the batch scaled by 1 + 1e-7, which
    shows how far f32 rounding of the forward alone moves the step."""
    import gc

    from icl_tpu_torch.data.brats import brats_train_batches
    from icl_tpu_torch.models.layers import DropPath
    from icl_tpu_torch.models.swinunetr import WindowAttention3D
    from icl_tpu_torch.train.trainer import Trainer

    cfg = train_config("float32", 1, 0, "step")
    batch = next(brats_train_batches(cases, 2, len(cases), TRAIN_BATCH, LABELED_BS, cfg.patch_size,
                                     seed=cfg.seed))
    watched = [f"swinViT.layers{i}.0.blocks.{b}.attn.{t}" for i in (1, 4) for b in (0, 1)
               for t in ("relative_position_bias_table", "qkv.weight", "qkv.bias")]

    def one_step(plain: bool, input_scale: float = 1.0):
        trainer = Trainer(cfg, device=DEVICE)
        for m in trainer.model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
            if plain and isinstance(m, WindowAttention3D):
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
    kernel_launches = (sum(FWD_PER_STEP.values()), sum(BWD_PER_STEP.values()))
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
    print(f"[step] one f32 step, kernel vs plain attention: loss terms {kern[0]} vs {plain[0]}", flush=True)
    for name, (le, ue) in errs.items():
        print(f"[step] {name}: loss terms' relative errors {le} (tolerance {STEP_LOSS_RTOL}); "
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
    for lib_path, log in builds:
        print(f"[build] {lib_path}{' (already built)' if not log else ''}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {line.strip()}")
    print(f"[build] both libraries in {build_s:.2f} s", flush=True)
    z = [torch.zeros(1, 1, 8, HEAD_DIM, device=DEVICE) for _ in range(4)]
    wa.window_attention(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), scale=1.0)
    wa.window_attention_bwd(*z[:3], torch.zeros(1, 8, 8, device=DEVICE), None, z[3], scale=1.0)
    torch.cuda.synchronize()

    # 3 + 4. the kernel against its plain version, and times
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
                       "max_abs_err": max_err}
                if not ok or not torch.isfinite(got).all():
                    fail(f"kernel disagrees with plain: {row}")
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
                    flop_ms, byte_ms = bound(B, H, N, D, nW, ids is not None)
                    row.update(
                        ms=cuda_ms(lambda: wa.window_attention(q, k, v, bias, ids, scale=scale)),
                        plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, scale=scale)),
                        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask, scale=scale)),
                        library_max_abs_err=lib_err,
                        flop_ms=flop_ms, byte_ms=byte_ms, bound_ms=max(flop_ms, byte_ms),
                        bound_by="operations" if flop_ms >= byte_ms else "bytes",
                    )
                    del mask, lib_out
                per_shape.append(row)
                print(f"[kernel] {json.dumps(row)}", flush=True)
                del q, k, v, bias, got, want, err
    torch.cuda.empty_cache()

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

    # the kernels line. Forward entries: times per inference forward at its
    # shapes (phase 4); backward entries: times per training step (2
    # passes) at the training shapes (phase 8). `launches`: the training
    # path's run (phase 9, 3 steps and one validation); the forward
    # kernels' launches on the inference path (phase 5) beside it.
    kernels = []
    for mode in ("region", "none"):
        rows = {r["stage"]: r for r in per_shape if r["mode"] == mode and r["dtype"] == "float32"}
        w = PER_FORWARD[mode]
        tot = {key: sum(rows[s][key] * n for s, n in w.items())
               for key in ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")}
        kernels.append({
            "name": f"window_attention[{mode}]",
            "route": "cuda",
            "source": "icl_tpu_torch/ops/csrc/window_attention.cu",
            "replaces": REPLACES[mode],
            "launches": training["path_launches"]["fwd"][mode],
            "launches_by_path": {"inference": launches[mode],
                                 "training": training["path_launches"]["fwd"][mode]},
            "max_abs_err": max(rows[s]["max_abs_err"] for s in w),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["flop_ms"], tot["byte_ms"]),
            "bound_by": "operations" if tot["flop_ms"] >= tot["byte_ms"] else "bytes",
            "library_ms": tot["library_ms"],
        })
    for mode in ("region", "none"):
        rows = {r["stage"]: r for r in bwd_rows if r["mode"] == mode and r["dtype"] == "float32"}
        per_step = {s: 2 * n for s, n in PER_FORWARD[mode].items()}
        tot = {key: sum(rows[s][key] * n for s, n in per_step.items())
               for key in ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")}
        kernels.append({
            "name": f"window_attention_bwd[{mode}]",
            "route": "cuda",
            "source": "icl_tpu_torch/ops/csrc/window_attention_bwd.cu",
            "replaces": BWD_REPLACES,
            "launches": training["path_launches"]["bwd"][mode],
            "max_abs_err": max(r["max_abs_err"] for r in bwd_rows if r["mode"] == mode),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["flop_ms"], tot["byte_ms"]),
            "bound_by": "operations" if tot["flop_ms"] >= tot["byte_ms"] else "bytes",
            "library_ms": tot["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
