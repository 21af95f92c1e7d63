"""The port's device rule: entry points run on the CUDA card unless the
caller asks for the CPU. They never fall back to the CPU quietly."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card. Raises when CUDA is asked for (or
    implied) and absent; pass `device="cpu"` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "icl_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
