"""The chunked window-attention forward (head dims above 64,
`csrc/window_attention_wide.cu`) at SwinUNETR's inference stage 1
([1372, 3, 343, D]; D 80 is fs240's, 128 fs384's) and a Swin-UNet's 2D
stage 1 at 128 a head ([512, 3, 144, 128]): each case checked against
`window_attention_plain` (its largest error printed; a copy of the kernel
with a part taken out gives wrong results, and is timed all the same),
timed on the device alone (`chip_smoke.py`'s `cuda_ms` behind a GPU
sleep), and its device time split by kernel with `torch.profiler` (the
term array, the forward). One `[profile-wide-fwd]` line a case, then the
registers and spill stores of each instance of the library and the card's
name and power limit.

    python icl_tpu_torch/scripts/profile_wide_fwd.py [label]
    PYTHONPATH=<other checkout> python icl_tpu_torch/scripts/profile_wide_fwd.py other

Run it as a file. `icl_tpu_torch` comes from PYTHONPATH when that names
another checkout (or a copy of the package with a changed kernel), else
from this one: versions are compared in turns in one call, on one card.
Exits non-zero where a case disagrees with the plain version, after every
case has run.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("terms_kernel", "wide_kernel")
# (D, mode, dtype, 2D): fs240's and fs384's stage 1, the 2D stage 1 at 128 a head
CASES = [(80, "none", "float32", False), (80, "region", "float32", False), (80, "none", "bfloat16", False),
         (80, "region", "bfloat16", False), (128, "none", "float32", False), (128, "none", "bfloat16", False),
         (128, "none", "float32", True), (128, "none", "bfloat16", True)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "this"
    sys.path.append(str(ROOT))  # after PYTHONPATH: another checkout's package wins
    import torch

    if not torch.cuda.is_available():
        print("profile_wide_fwd: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.QUEUE_BEHIND_SLEEP = True
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.ops.build import build_library

    torch.backends.cuda.matmul.allow_tf32 = False
    _, log = build_library("window_attention_wide")  # its -Xptxas -v log, where this call builds it
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(22)
    ok = True
    for D, mode, dtype_name, flat in CASES:
        dtype = getattr(torch, dtype_name)
        ids = None
        if flat:
            q, k, v, bias, _ = smoke.inputs_2d(torch, smoke.STAGES_2D[0], dtype, gen, None, head_dim=D)
        else:
            q, k, v, bias, ids = smoke.stage_inputs(torch, smoke.STAGES[0], dtype, gen, D)
            ids = ids if mode == "region" else None
        scale = D ** -0.5

        def call():
            return wa.window_attention_fwd(q, k, v, bias, ids, scale=scale)

        got = call()
        torch.cuda.synchronize()
        want = wa.window_attention_plain(q, k, v, bias, ids, scale=scale)
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            right = float(err.max()) <= smoke.F32_ATOL
        else:
            right = bool((err <= smoke.BF16_ATOL + smoke.BF16_RTOL * want.float().abs()).all())
        ok = ok and right
        ms = smoke.cuda_ms(call)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            name = next((n for n in KERNELS if n in e.key), None)
            if t > 0 and name:
                by_kernel[name] = by_kernel.get(name, 0.0) + t / 3 / 1e3
        row = {"label": label, "shape": list(q.shape), "mode": mode, "dtype": dtype_name, "ms": ms,
               "kernels_ms": by_kernel, "max_abs_err": float(err.max()), "right": right}
        print(f"[profile-wide-fwd] {json.dumps(row)}", flush=True)
        del q, k, v, bias, got, want, err
        torch.cuda.empty_cache()
    usage = smoke.ptxas_usage(log, "window_attention") if log else "already built"
    print(f"[profile-wide-fwd] registers and spill stores: {json.dumps(usage)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or "nvidia-smi: no output")
    if not ok:
        print("profile_wide_fwd: a case disagrees with the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
