"""The window-attention kernels, forward and backward, at every attention
shape of the port's paths: `chip_smoke.py`'s kernel phases 3 + 4 (the
forward at the SwinUNETR inference shapes, N = 343 and 216, head dim 16),
7 + 8 (the backward at the SwinUNETR-ICL training shapes) and 12 + 13
(both at Swin-UNet 2D's 384^2, the 224^2 / window-7 stage 1 and a 2 x 2
window, head dim 32), 28 (both at the supervised Swin paths' shapes:
224^2 / window 7 at batch 16 in f32, SwinUNETR at batch 4 in bf16) and 54
(both at SwinUNETR fs24's shapes, head dim 8, and at other head dims'
stage 1) and 57 (both at fs192's shapes, head dim 64, at the 2D
stage-1 shapes at head dim 64, and at head dims 33-63), each case checked
against the plain version, bitwise repeatable and timed, and nothing else
of the smoke test. `--paths` leaves out 54 and 57; `--tiles` runs only the
tile grid instead: both kernels at the head dim of each of their tiles
(`HEAD_DIM_TILES` of the package timed: 16, 32 and 64), f32 and bf16, no
mask, region ids and the dense mask made from them, at SwinUNETR's
training stage-1 windows ([686, 3, 343, D]), each checked against the
plain version and timed. `--paths` calls head dims 16 and 32 only, so it
also times kernels compiled for those two only. `--bwd64` runs only the
tile-64 shapes of SwinUNETR fs192's and fs120's training stage 1 ([686, 3,
343, 64] and [.., 40], no mask and region ids) and of the Swin-UNet 2D
stage 1 at 3 heads of 64 ([512, 3, 144, 64] and [512, 3, 49, 64], no mask
and the shift mask), f32 and bf16: the backward (fed the forward's output
and log-sum-exp where the package's backward takes them), the forward, and
the backward of F.scaled_dot_product_attention on the same inputs, each
checked against the plain version and timed. `--fwd64` runs only the
tile-64 forward at SwinUNETR fs192's inference stage 1 ([1372, 3, 343,
64]) and at head dim 40 (fs120), no mask and region ids, and at the
Swin-UNet 2D stage 1 at 3 heads of 64 ([512, 3, 144, 64] and [512, 3, 49,
64]), no mask and the shift mask, f32 and bf16: the forward without and
with its row log-sum-exp store, each checked against the plain version
(the log-sum-exp too), beside F.scaled_dot_product_attention's forward in
the same type, the plain version and the bound. `--wide` runs only head
dims above 64 (the tile-64 kernels in 64-column chunks): SwinUNETR fs240's
and fs384's stage 1 (head dims 80 and 128; the forward at the inference
shape [1372, 3, 343, D], the backward at the training one [686, 3, 343,
D]), no mask and region ids, and the Swin-UNet 2D stage-1 shapes at 3
heads of 128, no mask and the shift mask, f32 and bf16: the `--fwd64` row
and the `--bwd64` row of each; `--wide-bwd` the `--bwd64` rows alone, then
the backward at every SwinUNETR fs240 training stage (`chip_smoke.py`'s
phase 59 rows, f32 timed), whose times and launches a step make its
per-step sum; `--wide-fwd` the `--fwd64` rows alone, then the forward at
every SwinUNETR fs240 inference and training stage (`chip_smoke.py`'s
phase 59 rows, f32 and bf16 timed), whose times and launches a forward or
a step make its sums; `--fs240-cli` runs only
`chip_smoke.py`'s phase 60 (SwinUNETR-ICL fs240 through its CLI's `main`
at its default bf16 precision, 3 steps and a validation on seeded
synthetic cases, its final train state gathered but not written): its
s/step and peak memory, as the kernels' users pay for them. `--stream`
runs only `chip_smoke.py`'s phase 61 shapes (the streamed kernels, every
head dim: SwinUNETR fs432's stage 1 [1372, 3, 343, 144] and [686, 3, 343,
144], no mask and region ids; the Swin-UNet 2D stage 1 at 192 a head
[512, 1, 144, 192], no mask, the shift mask and a random one; head dims
129-648), f32 and bf16, both directions checked, f32 timed beside the
bound, the plain version and SDPA.

    python icl_tpu_torch/scripts/bench_kernels.py [--device-time] [--paths | --tiles | --bwd64 | --fwd64 |
                                                   --wide | --wide-bwd | --wide-fwd | --fs240-cli |
                                                   --stream]
    PYTHONPATH=<other checkout> python icl_tpu_torch/scripts/bench_kernels.py

Run it as a file. `icl_tpu_torch` comes from PYTHONPATH when that names
another checkout, else from this one, while the phases are always this
checkout's: two versions of the kernels are timed by the same code, in
turns, on one card. Prints the phases' rows, then the card's name and
power limit; exits non-zero on any disagreement. Times are those of
`chip_smoke.py` (back-to-back calls between CUDA events, the host's time
to issue each call included); with `--device-time` the calls are queued
behind a GPU sleep first, so that the events time the device alone.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device-time", action="store_true",
                   help="time the device alone: queue the timed calls behind a GPU sleep")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--paths", action="store_true",
                       help="the paths' shapes only (head dims 16 and 32), not phases 54 and 57")
    which.add_argument("--tiles", action="store_true",
                       help="only the tile grid: each tile's head dim, f32 and bf16, every mode")
    which.add_argument("--bwd64", action="store_true",
                       help="only the tile-64 training shapes, f32 and bf16, beside SDPA's backward")
    which.add_argument("--fwd64", action="store_true",
                       help="only the tile-64 forward, f32 and bf16, with and without its LSE, beside SDPA's forward")
    which.add_argument("--wide", action="store_true",
                       help="only head dims above 64 (80, 128), both kernels, f32 and bf16, beside SDPA")
    which.add_argument("--wide-bwd", action="store_true",
                       help="only the backward rows of --wide, then the backward at fs240's training stages")
    which.add_argument("--wide-fwd", action="store_true",
                       help="only the forward rows of --wide, then the forward at fs240's stages")
    which.add_argument("--fs240-cli", action="store_true",
                       help="only chip_smoke.py's phase 60: SwinUNETR-ICL fs240 through its CLI, s/step and peak")
    which.add_argument("--stream", action="store_true",
                       help="only chip_smoke.py's phase 61 shapes: the streamed kernels, every head dim")
    args = p.parse_args(argv)
    sys.path.append(str(ROOT))  # after PYTHONPATH: another checkout's package wins
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.QUEUE_BEHIND_SLEEP = args.device_time
    from icl_tpu_torch.ops import window_attention as wa

    print(f"[bench] icl_tpu_torch from {Path(wa.__file__).resolve().parents[2]}; "
          f"{'device time' if args.device_time else 'time per call'}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tiles:
        tile_grid(torch, wa, smoke)
    elif args.bwd64:
        tile64_shapes(torch, F, wa, smoke)
    elif args.fwd64:
        tile64_forward(torch, F, wa, smoke)
    elif args.wide_fwd:
        wide_forward(torch, F, wa, smoke)
    elif args.fs240_cli:
        fs240_cli(torch, wa, smoke)
    elif args.stream:
        smoke.stream_shape_rows(torch, F, wa)
    elif args.wide or args.wide_bwd:
        wide_head_dims(torch, F, wa, smoke, forward=args.wide)
        if args.wide_bwd:
            smoke.phase_backward_kernel(torch, F, wa, head_dim=smoke.FS240 // 3, tag="[wide-step]")
    else:
        smoke.phase_kernel_3d(torch, F, wa)
        smoke.phase_backward_kernel(torch, F, wa)
        smoke.phase_kernels_2d(torch, F, wa)
        smoke.phase_kernels_supervised(torch, F, wa)
        if not args.paths:
            smoke.phase_kernels_head_dims(torch, F, wa)
            smoke.phase_kernels_tile64(torch, F, wa)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or "nvidia-smi: no output")
    return 0


def tile_grid(torch, wa, smoke) -> None:
    """`--tiles`: forward and backward at [686, 3, 343, D] for D each tile
    of the package timed (`wa.HEAD_DIM_TILES`), f32 and bf16, in the NONE,
    REGION and MASK modes (the dense mask [343, 343, 343] of the region
    ids), each against its plain version with the smoke test's
    tolerances, then timed; one `[tiles]` line per case."""
    import json

    stage = (smoke.STAGES[0][0], smoke.LABELED_BS) + tuple(smoke.STAGES[0][2:])
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(16)
    for D in wa.HEAD_DIM_TILES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, ids = smoke.stage_inputs(torch, stage, dtype, gen, D)
            g = torch.randn(q.shape, device=smoke.DEVICE, generator=gen).to(dtype)
            dense = wa.mask_from_region_ids(ids)
            scale = D ** -0.5
            f32 = dtype == torch.float32
            for mode, r, m in (("none", None, None), ("region", ids, None), ("mask", None, dense)):
                out = wa.window_attention(q, k, v, bias, r, m, scale=scale)
                want = wa.window_attention_plain(q, k, v, bias, r, m, scale=scale)
                err = (out.float() - want.float()).abs()
                ok = float(err.max()) <= smoke.F32_ATOL if f32 else \
                    bool((err <= smoke.BF16_ATOL + smoke.BF16_RTOL * want.float().abs()).all())
                saved = smoke.saved_forward(wa, q, k, v, bias, r, m, scale)
                grads = wa.window_attention_bwd(q, k, v, bias, r, g, scale=scale, mask=m, **saved)
                wants = wa.window_attention_plain_bwd(q, k, v, bias, r, g, scale=scale, mask=m)
                rel = {n: smoke.rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv", "dbias"), grads, wants)}
                ok = ok and all(e <= (smoke.BWD_F32_RTOL if f32 or n == "dbias" else smoke.BWD_BF16_RTOL)
                                for n, e in rel.items())
                row = {"shape": list(q.shape), "dtype": str(dtype).split(".")[-1], "mode": mode,
                       "fwd_max_abs_err": float(err.max()), "bwd_rel_err": rel,
                       "fwd_ms": smoke.cuda_ms(lambda: wa.window_attention(q, k, v, bias, r, m, scale=scale)),
                       "bwd_ms": smoke.cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, r, g,
                                                                               scale=scale, mask=m, **saved))}
                print(f"[tiles] {json.dumps(row)}", flush=True)
                if not ok:
                    smoke.fail(f"[tiles] a kernel disagrees with its plain version: {row}")
                del out, want, err, grads, wants, saved
            del q, k, v, bias, ids, g, dense
            torch.cuda.empty_cache()


def tile64_shapes(torch, F, wa, smoke) -> None:
    """`--bwd64`: the backward, the forward and SDPA's backward at the
    tile-64 training shapes, f32 and bf16 (`backward_row`); one `[bwd64]`
    line per case."""
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(64)
    cases = [("fs192_stage1", 64, mode) for mode in ("none", "region")]
    cases += [("fs120_stage1", 40, mode) for mode in ("none", "region")]
    cases += [(stage[0] + "_2d", 64, mode) for stage in smoke.STAGES_2D_D64 for mode in ("none", "mask")]
    for name, D, mode in cases:
        for dtype in (torch.float32, torch.bfloat16):
            backward_row(torch, F, wa, smoke, "bwd64", gen, *case_inputs(torch, smoke, gen, name, D, mode, dtype,
                                                                         training=True))
            torch.cuda.empty_cache()


def tile64_forward(torch, F, wa, smoke) -> None:
    """`--fwd64`: the tile-64 forward at fs192's and fs120's inference
    stage 1 (no mask, region ids) and the 2D stage-1 shapes at head dim 64
    (no mask, the shift mask), f32 and bf16 (`forward_row`); one `[fwd64]`
    line per case."""
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(19)
    cases = [("fs192_stage1", 64, mode) for mode in ("none", "region")]
    cases += [("fs120_stage1", 40, mode) for mode in ("none", "region")]
    cases += [(stage[0] + "_2d", 64, mode) for stage in smoke.STAGES_2D_D64 for mode in ("none", "mask")]
    for name, D, mode in cases:
        for dtype in (torch.float32, torch.bfloat16):
            forward_row(torch, F, wa, smoke, "fwd64", *case_inputs(torch, smoke, gen, name, D, mode, dtype,
                                                                   training=False))
            torch.cuda.empty_cache()


def wide_head_dims(torch, F, wa, smoke, forward: bool = True) -> None:
    """`--wide`: head dims above 64, both kernels at SwinUNETR fs240's and
    fs384's stage 1 (the forward at the inference shape, the backward at
    the training one; no mask, region ids) and the 2D stage-1 shapes at 3
    heads of 128 (no mask, the shift mask), f32 and bf16: a `[wide-fwd]`
    line (`forward_row`, unless not `forward`) and a `[wide-bwd]` line
    (`backward_row`) per case."""
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(20)
    cases = [(f"fs{3 * D}_stage1", D, mode) for D in (80, 128) for mode in ("none", "region")]
    cases += [(stage[0] + "_2d", 128, mode) for stage in smoke.STAGES_2D_D64 for mode in ("none", "mask")]
    for name, D, mode in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if forward:
                forward_row(torch, F, wa, smoke, "wide-fwd", *case_inputs(torch, smoke, gen, name, D, mode, dtype,
                                                                          training=False))
                torch.cuda.empty_cache()
            backward_row(torch, F, wa, smoke, "wide-bwd", gen, *case_inputs(torch, smoke, gen, name, D, mode, dtype,
                                                                            training=True))
            torch.cuda.empty_cache()


def wide_forward(torch, F, wa, smoke) -> None:
    """`--wide-fwd`: the `[wide-fwd]` lines of `--wide` alone, then the
    forward at every fs240 inference stage (`[wide-fwd-fs240]`) and
    training stage (`[wide-fwd-fs240-step]`), no mask and region ids, f32
    and bf16 (`chip_smoke.phase_kernel_3d`)."""
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(20)
    cases = [(f"fs{3 * D}_stage1", D, mode) for D in (80, 128) for mode in ("none", "region")]
    cases += [(stage[0] + "_2d", 128, mode) for stage in smoke.STAGES_2D_D64 for mode in ("none", "mask")]
    for name, D, mode in cases:
        for dtype in (torch.float32, torch.bfloat16):
            forward_row(torch, F, wa, smoke, "wide-fwd", *case_inputs(torch, smoke, gen, name, D, mode, dtype,
                                                                      training=False))
            torch.cuda.empty_cache()
    for stages, tag in ((smoke.STAGES, "[wide-fwd-fs240]"), (smoke.TRAIN_STAGES, "[wide-fwd-fs240-step]")):
        smoke.phase_kernel_3d(torch, F, wa, head_dim=smoke.FS240 // 3, stages=stages, tag=tag, timed_bf16=True)


def fs240_cli(torch, wa, smoke) -> None:
    """`--fs240-cli`: phase 60 on phase 9's seeded cases, its final state
    gathered but not written; a `[fs240-cli]` line."""
    import json
    import shutil

    from icl_tpu_torch.data.synth import synthetic_brats_cases

    shutil.rmtree(smoke.EXPERIMENTS, ignore_errors=True)
    cases = synthetic_brats_cases(4, smoke.CASE_SIZE, seed=0)
    held_out = synthetic_brats_cases(1, smoke.CASE_SIZE, seed=1)
    with smoke.final_state_not_written("phase_fs240_cli"):
        run = smoke.phase_fs240_cli(torch, wa, cases, held_out)
    shutil.rmtree(smoke.EXPERIMENTS, ignore_errors=True)
    keys = ("s_per_step", "peak_bytes", "build_s", "val_dice", "path_launches")
    print(f"[fs240-cli] {json.dumps({k: run[k] for k in keys})}", flush=True)


def case_inputs(torch, smoke, gen, name: str, D: int, mode: str, dtype, training: bool) -> tuple:
    """(name, mode, q, k, v, bias, ids, mask) of a case: a 2D stage-1 shape
    (`name` ending in _2d; the shift mask for `mode` mask), or the 3D stage
    1 of SwinUNETR's inference forward, or of its training pass
    (`training`), with region ids for `mode` region."""
    ids = mask = None
    if name.endswith("_2d"):
        stage = next(st for st in smoke.STAGES_2D_D64 if st[0] + "_2d" == name)
        q, k, v, bias, mask = smoke.inputs_2d(torch, stage, dtype, gen, "shift" if mode == "mask" else None,
                                              head_dim=D)
    else:
        stage = (smoke.STAGES[0][0], smoke.LABELED_BS) + tuple(smoke.STAGES[0][2:]) if training else smoke.STAGES[0]
        q, k, v, bias, ids = smoke.stage_inputs(torch, stage, dtype, gen, D)
        ids = ids if mode == "region" else None
    return name, mode, q, k, v, bias, ids, mask


def dense_mask(wa, ids, mask):
    """The additive mask SDPA and the bound take: the dense mask, or the
    one the region ids make, or None."""
    return mask if mask is not None else wa.mask_from_region_ids(ids) if ids is not None else None


def backward_row(torch, F, wa, smoke, tag: str, gen, name, mode, q, k, v, bias, ids, mask) -> None:
    """The backward (fed the forward's output and log-sum-exp where the
    package's backward takes them), the forward and SDPA's backward on one
    case, checked against the plain backward with the smoke test's
    tolerances, then timed beside the bound; a `[<tag>]` line."""
    import json

    dtype, (B, H, N, D) = q.dtype, q.shape
    g = torch.randn(q.shape, device=smoke.DEVICE, generator=gen).to(dtype)
    scale = D ** -0.5
    f32 = dtype == torch.float32
    saved = smoke.saved_forward(wa, q, k, v, bias, ids, mask, scale)
    grads = wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask, **saved)
    wants = wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask)
    rel = {n: smoke.rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv", "dbias"), grads, wants)}
    ok = all(e <= (smoke.BWD_F32_RTOL if f32 or n == "dbias" else smoke.BWD_BF16_RTOL) for n, e in rel.items())
    dense = dense_mask(wa, ids, mask)
    flop_ms, byte_ms = smoke.bound(B, H, N, D, dense.numel() if dense is not None else 0, backward=True,
                                   elem_bytes=4 if f32 else 2,
                                   flops_rate=smoke.F32_ACCURATE_FLOPS if f32 else smoke.BF16_FLOPS)
    row = {"case": name, "shape": list(q.shape), "dtype": str(dtype).split(".")[-1], "mode": mode,
           "bwd_rel_err": rel, "saved_lse": bool(saved),
           "bwd_ms": smoke.cuda_ms(lambda: wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, mask=mask,
                                                                   **saved)),
           "fwd_ms": smoke.cuda_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)),
           "sdpa_bwd_ms": smoke.sdpa_backward_ms(torch, F, q, k, v, bias, dense, g, scale),
           "plain_bwd_ms": smoke.cuda_ms(lambda: wa.window_attention_plain_bwd(q, k, v, bias, ids, g, scale=scale,
                                                                               mask=mask), reps=3),
           **smoke.bound_fields(flop_ms, byte_ms)}
    if saved:
        row["fwd_lse_ms"] = smoke.cuda_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale,
                                                                          return_lse=True))
    print(f"[{tag}] {json.dumps(row)}", flush=True)
    if not ok:
        smoke.fail(f"[{tag}] the backward kernel disagrees with its plain version: {row}")


def forward_row(torch, F, wa, smoke, tag: str, name, mode, q, k, v, bias, ids, mask) -> None:
    """The forward without and with its log-sum-exp, SDPA's forward in the
    same type and the plain version on one case, checked against the plain
    version with the smoke test's tolerances (the log-sum-exp at f32's 1e-5
    of its magnitude), then timed beside the bound; a `[<tag>]` line."""
    import json

    dtype, (B, H, N, D) = q.dtype, q.shape
    scale = D ** -0.5
    f32 = dtype == torch.float32
    out, lse = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    alone = wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)
    want, want_lse = wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale, return_lse=True)
    err = (out.float() - want.float()).abs()
    ok = float(err.max()) <= smoke.F32_ATOL if f32 else \
        bool((err <= smoke.BF16_ATOL + smoke.BF16_RTOL * want.float().abs()).all())
    lse_err = float((lse - want_lse).abs().max())
    ok = ok and torch.equal(out, alone) and lse_err <= smoke.F32_ATOL * max(1.0, float(want_lse.abs().max()))
    dense = dense_mask(wa, ids, mask)
    nW = dense.shape[0] if dense is not None else B
    shape = (B // nW, nW, H, N, D) if dense is not None else (B, H, N, D)
    qs, ks, vs = (t.view(shape) for t in (q, k, v))
    attn = (bias if dense is None else bias[None] + dense[:, None]).to(dtype)
    flop_ms, byte_ms = smoke.bound(B, H, N, D, dense.numel() if dense is not None else 0, elem_bytes=4 if f32 else 2,
                                   flops_rate=smoke.F32_ACCURATE_FLOPS if f32 else smoke.BF16_FLOPS)
    row = {"case": name, "shape": list(q.shape), "dtype": str(dtype).split(".")[-1], "mode": mode,
           "max_abs_err": float(err.max()), "lse_max_abs_err": lse_err,
           "fwd_ms": smoke.cuda_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale)),
           "fwd_lse_ms": smoke.cuda_ms(lambda: wa.window_attention_fwd(q, k, v, bias, ids, mask, scale=scale,
                                                                       return_lse=True)),
           "sdpa_ms": smoke.cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn, scale=scale)),
           "plain_ms": smoke.cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, ids, mask, scale=scale), reps=3),
           **smoke.bound_fields(flop_ms, byte_ms)}
    print(f"[{tag}] {json.dumps(row)}", flush=True)
    if not ok:
        smoke.fail(f"[{tag}] the forward kernel disagrees with its plain version: {row}")


if __name__ == "__main__":
    sys.exit(main())
