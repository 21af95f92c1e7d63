"""Model factory (counterpart of `icl_tpu/models/registry.py`) for the
models the port has so far."""
from __future__ import annotations

import torch

from icl_tpu_torch.device import resolve_device

PORTED = ("swinunetr", "swinunetr_icl")


def net_factory(net_type: str, in_chns: int, class_num: int, *, device=None,
                generator: torch.Generator | None = None, feature_size: int = 48,
                patch_size: int = 96, remat: bool = False, inference: bool = False):
    """String -> initialised model on `device` (the CUDA card by default),
    in torch's default train mode, with weights drawn from `generator`
    (default: seed 0). `swinunetr_icl` builds `SwinUNETRICL`; with
    `inference=True` it builds the `SwinUNETR` it runs at inference, which
    is what its best checkpoint (ICL heads stripped) loads into. The same
    seed gives the same backbone weights either way."""
    if net_type not in PORTED:
        raise KeyError(f"net_type {net_type!r} is not ported yet; ported: {list(PORTED)}")
    from icl_tpu_torch.models.swinunetr import SwinUNETR, build_model
    from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = resolve_device(device)
    if net_type == "swinunetr_icl" and not inference:
        return build_model(SwinUNETRICL, in_chns, class_num, img_size=patch_size,
                           feature_size=feature_size, remat=remat, device=device,
                           generator=generator)
    return build_model(SwinUNETR, in_chns, class_num, feature_size=feature_size, remat=remat,
                       device=device, generator=generator)
