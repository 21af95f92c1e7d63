"""The window-attention kernels, forward and backward, at every attention
shape of the port's paths: `chip_smoke.py`'s kernel phases 3 + 4 (the
forward at the SwinUNETR inference shapes, N = 343 and 216, head dim 16),
7 + 8 (the backward at the SwinUNETR-ICL training shapes) and 12 + 13
(both at Swin-UNet 2D's 384^2, the 224^2 / window-7 stage 1 and a 2 x 2
window, head dim 32) and 28 (both at the supervised Swin paths' shapes:
224^2 / window 7 at batch 16 in f32, SwinUNETR at batch 4 in bf16), each
case checked against the plain version,
bitwise repeatable and timed, and nothing else of the smoke test.

    python icl_tpu_torch/scripts/bench_kernels.py [--device-time]
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
    smoke.phase_kernel_3d(torch, F, wa)
    smoke.phase_backward_kernel(torch, F, wa)
    smoke.phase_kernels_2d(torch, F, wa)
    smoke.phase_kernels_supervised(torch, F, wa)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
