"""Where the time of one SwinUNETR sw_batch forward goes on the card.

    python -m icl_tpu_torch.scripts.profile_forward

Runs one warm-up and then one profiled forward of the BraTS eval shape
(fs48, sw_batch 4, 96^3 patches; seeded weights and input, f32 with TF32
off, as `chip_smoke.py`), and prints the device time by
kernel group, the top kernels, the forward's wall time and the card's
idle share over it, then one JSON line with the same numbers. Needs a
CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

from icl_tpu_torch.eval.infer3d import make_patch_predictor
from icl_tpu_torch.models.registry import net_factory

# kernel-name substrings -> group, first match wins. cuDNN names its
# convolutions' implicit GEMMs fprop/dgrad/wgrad, its FFT convolutions'
# transforms fft2d and their complex GEMMs cf32, its BatchNorms bn_fw and
# bn_bw; cuBLAS's kernels say gemm.
GROUPS = (
    ("window_attention_bwd", "window attention backward (this port's kernel)"),
    ("dbias_reduce", "window attention backward (this port's kernel)"),
    ("window_attention", "window attention (this port's kernel)"),
    ("conv", "convolution"),
    ("fprop", "convolution"),
    ("dgrad", "convolution"),
    ("wgrad", "convolution"),
    ("fft", "convolution"),
    ("cf32", "convolution"),
    ("bn_fw", "reductions (norms, softmax, argmax)"),
    ("bn_bw", "reductions (norms, softmax, argmax)"),
    ("gemm", "matmul (linears)"),
    ("gemv", "matmul (linears)"),
    ("xmma", "convolution"),
    ("multi_tensor", "optimizer (SGD)"),
    ("upsample", "linear resize (decoder upsample, loss maps)"),
    ("nchwtonhwc", "copies and layout"),
    ("nhwctonchw", "copies and layout"),
    ("reduce", "reductions (norms, softmax, argmax)"),
    ("norm", "reductions (norms, softmax, argmax)"),
    ("softmax", "reductions (norms, softmax, argmax)"),
    ("elementwise", "elementwise"),
    ("copy", "copies and layout"),
    ("cat", "copies and layout"),
    ("memcpy", "copies and layout"),
    ("memset", "copies and layout"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def device_time_by_group(prof) -> tuple[float, dict, dict, int]:
    """(busy ms, {group: ms}, {kernel name: [ms, calls]}, kernel count) of
    the device kernels a `torch.profiler.profile` recorded. The device-side
    spans of user annotations (`Optimizer.step#SGD.step`) cover kernels
    counted already and are left out."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        ms = e.device_time / 1e3  # device_time is in us
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + ms
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    return sum(by_group.values()), by_group, by_name, len(kernels)


FEATURE_SIZE, SW_BATCH, PATCH = 48, 4, 96


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    model = net_factory("swinunetr_icl", 1, 2, device="cuda", feature_size=FEATURE_SIZE,
                        generator=torch.Generator().manual_seed(0), inference=True).eval()
    probs_fn = make_patch_predictor(model)
    x = torch.randn(SW_BATCH, 1, PATCH, PATCH, PATCH, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    probs_fn(x)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probs_fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    busy_ms, by_group, by_name, n_kernels = device_time_by_group(prof)

    print(f"card: {card}")
    print(f"forward fs{FEATURE_SIZE} sw_batch {SW_BATCH} at {PATCH}^3: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, {n_kernels} kernels")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / busy_ms:6.1%}  {g}")
    print("top kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:10.3f} ms  x{n:<4d} {name[:110]}")
    print(json.dumps({"card": card, "wall_ms": wall_ms, "busy_ms": busy_ms,
                      "idle_share": 1 - busy_ms / wall_ms, "by_group_ms": by_group}))


if __name__ == "__main__":
    main()
