"""ICL-instrumented SwinUNETR 3D (counterpart of
`icl_tpu/models/swinunetr_icl.py`).

A SwinUNETR (subclassed, so the backbone keys stay at top level as in the
reference: `swinViT.*`, `encoder1.*`, ..., `out.*`) with two
`InherentConsistent` heads, `sspa` and `uscl`, on the decoder taps
[dec3, dec2, dec1]: in_chans (8fs, 4fs, 2fs), heads (24, 12, 6),
resolutions (P/16, P/8, P/4). A state_dict with the `sspa.` and `uscl.`
keys removed loads strictly into `SwinUNETR`. `fuse_sspa_pair` runs the
two labeled-mode `sspa` calls as one (`sspa_paired`,
swinunetr_icl.py:67-70); the backbone passes stay two.
"""
from __future__ import annotations

from typing import Sequence

from icl_tpu_torch.models.icl import InherentConsistent, sspa_paired
from icl_tpu_torch.models.swinunetr import SwinUNETR

HEAD_PREFIXES = ("sspa.", "uscl.")


def strip_icl_heads(state_dict: dict) -> dict:
    """The reference best-checkpoint rule: drop the ICL heads."""
    return {k: v for k, v in state_dict.items() if not k.startswith(HEAD_PREFIXES)}


class SwinUNETRICL(SwinUNETR):
    def __init__(self, in_chns: int, class_num: int, img_size: int = 96, feature_size: int = 48,
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Sequence[int] = (7, 7, 7), remat: bool = False,
                 fuse_sspa_pair: bool = False):
        super().__init__(in_chns, class_num, feature_size, num_heads=num_heads,
                         window_size=window_size, return_feats=True, remat=remat)
        self.fuse_sspa_pair = fuse_sspa_pair
        fs = feature_size
        icl_kwargs = dict(
            in_chans=(8 * fs, 4 * fs, 2 * fs),
            num_classes=class_num,
            num_heads=tuple(reversed(num_heads))[:3],
            input_resolution=(img_size // 16, img_size // 8, img_size // 4),
            spatial_dims=3,
        )
        self.sspa = InherentConsistent(**icl_kwargs)
        self.uscl = InherentConsistent(**icl_kwargs)

    def forward(self, x_lab, x_unlab=None, *, inference: bool = False):
        """Backbone logits alone for inference or without an unlabeled
        batch; else (logits_lab, logits_unlab, feat_maps_lab,
        feat_maps_unlab, feat_maps_consis) from two sequential
        shared-weight backbone passes (swinunetr_icl.py:51-77)."""
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
