"""Model factory (counterpart of `icl_tpu/models/registry.py`) for the
models the port has so far."""
from __future__ import annotations

import torch

from icl_tpu_torch.device import resolve_device

PORTED = ("swinunetr", "swinunetr_icl")


def net_factory(net_type: str, in_chns: int, class_num: int, *, device=None,
                generator: torch.Generator | None = None, feature_size: int = 48):
    """String -> initialised model on `device` (the CUDA card by default),
    in eval mode, with weights drawn from `generator` (default: seed 0).
    Both keys build SwinUNETR: for inference `swinunetr_icl` computes its
    backbone only, and its best checkpoint has the ICL heads stripped."""
    if net_type not in PORTED:
        raise KeyError(f"net_type {net_type!r} is not ported yet; ported: {list(PORTED)}")
    from icl_tpu_torch.models.swinunetr import build_swinunetr

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return build_swinunetr(in_chns, class_num, device=resolve_device(device), generator=generator,
                           feature_size=feature_size)
