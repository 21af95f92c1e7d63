"""The chunked window-attention backward (head dims above 64,
`csrc/window_attention_bwd_wide.cu`) at SwinUNETR's training stage 1
([686, 3, 343, D]; D 80 is fs240's, 128 fs384's): each case checked
against `window_attention_plain_bwd_lse`, timed on the device alone
(`chip_smoke.py`'s `cuda_ms` behind a GPU sleep), and its device time
split by kernel with `torch.profiler` (the term array, f32's u prologue,
the dQ and dK/dV kernels, the dbias reduction). One `[profile-wide-bwd]`
line a case, then the registers and spill stores of each instance of the
library, and the card's name and power limit.

    python icl_tpu_torch/scripts/profile_wide_bwd.py [label]
    PYTHONPATH=<other checkout> python icl_tpu_torch/scripts/profile_wide_bwd.py other

Run it as a file. `icl_tpu_torch` comes from PYTHONPATH when that names
another checkout (or a copy of the package with a changed kernel), else
from this one: versions are compared in turns in one call, on one card.
"""
from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("terms_kernel", "delta_kernel", "dq_kernel", "dkdv_kernel", "reduce64")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    label = argv[0] if argv else "this"
    sys.path.append(str(ROOT))  # after PYTHONPATH: another checkout's package wins
    import torch

    if not torch.cuda.is_available():
        print("profile_wide_bwd: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.QUEUE_BEHIND_SLEEP = True
    from icl_tpu_torch.ops import window_attention as wa
    from icl_tpu_torch.ops.build import build_library

    torch.backends.cuda.matmul.allow_tf32 = False
    _, log = build_library("window_attention_bwd_wide")  # its -Xptxas -v log, where this call builds it
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(20)
    stage = (smoke.STAGES[0][0], smoke.LABELED_BS) + tuple(smoke.STAGES[0][2:])
    ok = True
    for D, mode, dtype in [(80, "none", torch.float32), (80, "region", torch.float32), (80, "none", torch.bfloat16),
                           (80, "region", torch.bfloat16), (128, "none", torch.float32),
                           (128, "none", torch.bfloat16)]:
        q, k, v, bias, ids = smoke.stage_inputs(torch, stage, dtype, gen, D)
        ids = ids if mode == "region" else None
        g = torch.randn(q.shape, device=smoke.DEVICE, generator=gen).to(dtype)
        scale = D ** -0.5
        saved = smoke.saved_forward(wa, q, k, v, bias, ids, None, scale)

        def call():
            return wa.window_attention_bwd(q, k, v, bias, ids, g, scale=scale, **saved)

        got = call()
        torch.cuda.synchronize()
        want = wa.window_attention_plain_bwd_lse(q, k, v, bias, ids, saved["out"], saved["lse"], g, scale=scale)
        names = ("dq", "dk", "dv", "dbias")
        err = {n: smoke.rel_err(a, b) for n, a, b in zip(names, got, want)}
        f32 = dtype == torch.float32
        ok = ok and all(e <= (smoke.BWD_F32_RTOL if f32 or n == "dbias" else smoke.BWD_BF16_RTOL)
                        for n, e in err.items())
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
        row = {"label": label, "shape": list(q.shape), "mode": mode, "dtype": str(dtype).split(".")[-1],
               "ms": ms, "kernels_ms": by_kernel, "rel_err": err}
        print(f"[profile-wide-bwd] {json.dumps(row)}", flush=True)
        del q, k, v, g, bias, got, want, saved
        torch.cuda.empty_cache()
    print(f"[profile-wide-bwd] registers and spill stores: {json.dumps(usage(log)) if log else 'already built'}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or "nvidia-smi: no output")
    if not ok:
        print("profile_wide_bwd: a case disagrees with the plain version", file=sys.stderr)
        return 1
    return 0


def usage(log: str) -> dict:
    """{"<kernel> <type> <mode>": [registers, spill stores in bytes]} of
    the library's dQ and dK/dV instances, from its `-Xptxas -v` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"window_attention_bwd64_wide_(dq|dkdv)_kernelI(f|13__nv_bfloat16)Li(\d)E", line)
        if m:
            name = f"{m[1]} {'f32' if m[2] == 'f' else 'bf16'} {('none', 'region', 'mask')[int(m[3])]}"
        elif name and "spill stores" in line:
            out[name] = [None, int(re.search(r"(\d+) bytes spill stores", line)[1])]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line)[1])
            name = None
    return out


if __name__ == "__main__":
    sys.exit(main())
