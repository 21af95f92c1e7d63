"""ICL-instrumented 3D U-Net (counterpart of `icl_tpu/models/unet3d_icl.py`).

A UNet3D (subclassed, so the backbone keys stay at the root of the state
dict as `export_icl_unet3d` writes them: `conv1.*`, ..., `final.*`) that
also returns its taps [center (after dropout), up4, up3], and two
`InherentConsistent` heads `sspa` and `uscl` on them: in_chans (256, 128,
64), heads (16, 8, 4), resolutions (P/16, P/8, P/4) for patch side P (6,
12, 24 at 96^3, so `mlp2` is 13824^2 at the finest scale), the query
spelled `guided_Q`. The labeled and unlabeled sub-batches run as two
passes through the shared weights. A state_dict with the `sspa.` and
`uscl.` keys removed loads strictly into `UNet3D`.
"""
from __future__ import annotations

from icl_tpu_torch.models.icl import InherentConsistent, sspa_paired
from icl_tpu_torch.models.unet3d import DEFAULT_FILTERS_3D, UNet3D


class UNet3DICL(UNet3D):
    """`fuse_sspa_pair` runs the two labeled-mode `sspa` calls as one
    (`sspa_paired`). `zero_stochastic` turns dropout and drop path off: a
    step that another framework can match. `remat` recomputes the
    backbone's blocks in the backward (`UNet3D`)."""

    def __init__(self, in_chns: int, class_num: int, patch_size: int = 96,
                 fuse_sspa_pair: bool = False, zero_stochastic: bool = False, remat: bool = False):
        super().__init__(in_chns, class_num, return_feats=True, remat=remat,
                         dropout=0.0 if zero_stochastic else 0.3)
        ft = DEFAULT_FILTERS_3D
        self.fuse_sspa_pair = fuse_sspa_pair
        icl_kwargs = dict(
            in_chans=(ft[4], ft[3], ft[2]),
            num_classes=class_num,
            num_heads=(16, 8, 4),
            input_resolution=(patch_size // 16, patch_size // 8, patch_size // 4),
            spatial_dims=3,
            drop_path_rate=0.0 if zero_stochastic else 0.1,
            query_name="guided_Q",
        )
        self.sspa = InherentConsistent(**icl_kwargs)
        self.uscl = InherentConsistent(**icl_kwargs)

    def forward(self, x_lab, x_unlab=None, *, inference: bool = False):
        """Logits alone for inference or without an unlabeled batch; else
        (logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab,
        feat_maps_consis) (unet3d_icl.py:45-69)."""
        if inference or x_unlab is None:
            return super().forward(x_lab)[0]
        logits_lab, feats_lab = super().forward(x_lab)
        logits_unlab, feats_unlab = super().forward(x_unlab)
        if self.fuse_sspa_pair:
            feat_maps_lab, feat_maps_consis, updated_Qs_lab = sspa_paired(
                self.sspa, feats_lab, feats_unlab)
        else:
            feat_maps_lab, updated_Qs_lab = self.sspa(feats_lab, modal="labeled")
            feat_maps_consis, _ = self.sspa(feats_unlab, modal="labeled")
        feat_maps_unlab, _ = self.uscl(feats_unlab, updated_Qs_lab, modal="unlabeled")
        return logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab, feat_maps_consis
