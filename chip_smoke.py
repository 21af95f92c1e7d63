#!/usr/bin/env python3
"""Chip smoke test of icl_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: name and power limit (nvidia-smi), torch's device name;
  2. the build of the window-attention CUDA kernel from ops/csrc;
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
then a `kernels` JSON line, the card line, and the result line. Exits
non-zero without a result when CUDA is absent.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

F32_ATOL = 1e-5  # f32 rounding of 343-term sums in another order; 2e-6 seen on an H100
# bf16 inputs, f32 math in both versions, one bf16 rounding of the output:
# at most one bf16 ulp apart, i.e. 2^-7 relative
BF16_ATOL, BF16_RTOL = 1e-3, 1e-2
PROBS_ATOL = 1e-4  # end-to-end probabilities, f32 with TF32 off
F32_PEAK_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

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


def bound(B, H, N, D, nW, masked):
    flops = 4 * B * H * N * N * D
    nbytes = 4 * B * H * N * D * 4 + H * N * N * 4 + (nW * N * 4 if masked else 0)
    return flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


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

    # 2. the build
    t0 = time.perf_counter()
    lib_path, log = build_library("window_attention")
    build_s = time.perf_counter() - t0
    print(f"[build] {lib_path} in {build_s:.2f} s{' (already built)' if not log else ''}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")
    wa.window_attention(*(torch.zeros(1, 1, 8, HEAD_DIM, device=DEVICE) for _ in range(3)),
                        torch.zeros(1, 8, 8, device=DEVICE), scale=1.0)
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
                        generator=torch.Generator().manual_seed(0))
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

    # the kernels line: per forward, each variant's launches at its shapes
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
            "launches": launches[mode],
            "max_abs_err": max(rows[s]["max_abs_err"] for s in w),
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
