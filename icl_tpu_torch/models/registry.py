"""Model factory (counterpart of `icl_tpu/models/registry.py`) for the
models the port has so far."""
from __future__ import annotations

import torch

from icl_tpu_torch.device import resolve_device

PORTED = ("swinunetr", "swinunetr_icl", "swinunet", "icl_swinunet", "unet", "icl_unet", "unet_3D",
          "unet_3D_icl", "unet_cct", "unet_urpc", "unet_ds")


def net_factory(net_type: str, in_chns: int, class_num: int, *, device=None,
                generator: torch.Generator | None = None, feature_size: int = 48,
                patch_size: int | None = None, remat: bool = False, img_size: int = 224,
                window_size: int = 7, swin_cfg=None, inference: bool = False,
                fuse_sspa_pair: bool = False, zero_stochastic: bool = False):
    """String -> initialised model on `device` (the CUDA card by default),
    in torch's default train mode, with weights drawn from `generator`
    (default: seed 0). The same seed gives the same backbone weights with
    and without `inference`.

    3D: `swinunetr_icl` builds `SwinUNETRICL` (patch side `patch_size`,
    default 96); with `inference=True` it builds the `SwinUNETR` it runs
    at inference, which its best checkpoint (ICL heads stripped) loads
    into. `swinunetr` builds that SwinUNETR.

    2D: `icl_swinunet` builds `SwinUNetICL`, `swinunet` and `icl_swinunet`
    with `inference=True` the `SwinUnetWrapper`. The image side is
    `img_size`, or `patch_size` when `img_size` keeps its default 224 (the
    trainers pass the patch, registry.py:85-91); a full `swin_cfg`
    (`SwinConfig`, e.g. from a `--cfg` yaml) wins over both and over
    `window_size`.

    2D U-Net variants: `unet_cct`, `unet_urpc` and `unet_ds` build
    `UNetCCT`, `UNetURPC` and `UNetDS` (`models/unet2d_variants.py`).

    2D U-Net: `icl_unet` builds `UNetICL` (patch side `patch_size`,
    default 256; `fuse_sspa_pair` and `zero_stochastic` as that class
    takes them); `unet` and `icl_unet` with `inference=True` the `UNet`,
    which its best checkpoint loads into.

    3D U-Net: `unet_3D_icl` builds `UNet3DICL` (patch side `patch_size`,
    default 96; `fuse_sspa_pair`, `zero_stochastic` and `remat` as that
    class takes them); `unet_3D` and `unet_3D_icl` with `inference=True`
    the `UNet3D` (with `remat`, and dropout off under `zero_stochastic`),
    which its best checkpoint loads into."""
    if net_type not in PORTED:
        raise KeyError(f"net_type {net_type!r} is not ported yet; ported: {list(PORTED)}")
    if fuse_sspa_pair and net_type not in ("icl_unet", "unet_3D_icl"):
        raise ValueError("fuse_sspa_pair is ported for icl_unet and unet_3D_icl only")
    if zero_stochastic and net_type not in ("icl_unet", "unet_3D", "unet_3D_icl"):
        raise ValueError("zero_stochastic is ported for icl_unet, unet_3D and unet_3D_icl only")
    from icl_tpu_torch.models.layers import build_model

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    device = resolve_device(device)
    if net_type in ("unet", "icl_unet"):
        from icl_tpu_torch.models.unet2d import UNet
        from icl_tpu_torch.models.unet2d_icl import UNetICL

        if net_type == "icl_unet" and not inference:
            return build_model(UNetICL, in_chns, class_num, patch_size=patch_size or 256,
                               fuse_sspa_pair=fuse_sspa_pair, zero_stochastic=zero_stochastic,
                               device=device, generator=generator)
        return build_model(UNet, in_chns, class_num, device=device, generator=generator)
    if net_type in ("unet_cct", "unet_urpc", "unet_ds"):
        from icl_tpu_torch.models import unet2d_variants

        cls = {"unet_cct": unet2d_variants.UNetCCT, "unet_urpc": unet2d_variants.UNetURPC,
               "unet_ds": unet2d_variants.UNetDS}[net_type]
        return build_model(cls, in_chns, class_num, device=device, generator=generator)
    if net_type in ("unet_3D", "unet_3D_icl"):
        from icl_tpu_torch.models.unet3d import UNet3D
        from icl_tpu_torch.models.unet3d_icl import UNet3DICL

        if net_type == "unet_3D_icl" and not inference:
            return build_model(UNet3DICL, in_chns, class_num, patch_size=patch_size or 96,
                               fuse_sspa_pair=fuse_sspa_pair, zero_stochastic=zero_stochastic,
                               remat=remat, device=device, generator=generator)
        return build_model(UNet3D, in_chns, class_num, remat=remat,
                           dropout=0.0 if zero_stochastic else 0.3, device=device,
                           generator=generator)
    if net_type in ("swinunet", "icl_swinunet"):
        from icl_tpu_torch.models.swin2d import SwinUnetWrapper
        from icl_tpu_torch.models.swin2d_icl import SwinUNetICL

        side = img_size if img_size != 224 or patch_size is None else patch_size
        cls = SwinUNetICL if net_type == "icl_swinunet" and not inference else SwinUnetWrapper
        return build_model(cls, in_chns, class_num, img_size=side, window_size=window_size,
                           cfg=swin_cfg, device=device, generator=generator)
    from icl_tpu_torch.models.swinunetr import SwinUNETR
    from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL

    if net_type == "swinunetr_icl" and not inference:
        return build_model(SwinUNETRICL, in_chns, class_num, img_size=patch_size or 96,
                           feature_size=feature_size, remat=remat, device=device,
                           generator=generator)
    return build_model(SwinUNETR, in_chns, class_num, feature_size=feature_size, remat=remat,
                       device=device, generator=generator)
