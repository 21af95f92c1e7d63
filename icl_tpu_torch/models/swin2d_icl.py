"""ICL-instrumented Swin-UNet 2D (counterpart of
`icl_tpu/models/swin2d_icl.py`).

`swin_unet` is a `SwinUNet2D` that also returns its decoder taps; the two
`InherentConsistent` heads `sspa` and `uscl` take those tokens as they are
(tokenized, no proj conv or norm; the query spelled `guided_Q`): in_chans
(4E, 2E, E), heads (24, 12, 6), resolutions (P/16, P/8, P/4) for embed E
and image side P. A state_dict with the `sspa.` and `uscl.` keys removed
loads strictly into `SwinUnetWrapper`. `fuse_sspa_pair` runs the two
labeled-mode `sspa` calls as one (`sspa_paired`, swin2d_icl.py:61-64).
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from icl_tpu_torch.models.icl import InherentConsistent, sspa_paired
from icl_tpu_torch.models.swin2d import SwinConfig, SwinUNet2D, expand_gray


class SwinUNetICL(nn.Module):
    def __init__(self, in_chns: int, class_num: int, img_size: int = 224, window_size: int = 7,
                 cfg: Optional[SwinConfig] = None, fuse_sspa_pair: bool = False):
        super().__init__()
        cfg = cfg or SwinConfig(img_size=img_size, window_size=window_size)
        self.fuse_sspa_pair = fuse_sspa_pair
        self.swin_unet = SwinUNet2D(class_num, cfg, return_feats=True)
        pr = cfg.img_size // cfg.patch_size
        icl_kwargs = dict(
            in_chans=(4 * cfg.embed_dim, 2 * cfg.embed_dim, cfg.embed_dim),
            num_classes=class_num,
            num_heads=(24, 12, 6),
            input_resolution=(pr // 4, pr // 2, pr),
            spatial_dims=2,
            tokenized_input=True,
            query_name="guided_Q",
        )
        self.sspa = InherentConsistent(**icl_kwargs)
        self.uscl = InherentConsistent(**icl_kwargs)

    def forward(self, x_lab, x_unlab=None, *, inference: bool = False):
        """Logits alone for inference or without an unlabeled batch; else
        (logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab,
        feat_maps_consis) from two shared-weight backbone passes
        (swin2d_icl.py:55-83)."""
        x_lab = expand_gray(x_lab)
        if inference or x_unlab is None:
            return self.swin_unet(x_lab)[0]
        logits_lab, feats_lab = self.swin_unet(x_lab)
        logits_unlab, feats_unlab = self.swin_unet(expand_gray(x_unlab))
        if self.fuse_sspa_pair:
            feat_maps_lab, feat_maps_consis, updated_Qs_lab = sspa_paired(
                self.sspa, feats_lab, feats_unlab)
        else:
            feat_maps_lab, updated_Qs_lab = self.sspa(feats_lab, modal="labeled")
            feat_maps_consis, _ = self.sspa(feats_unlab, modal="labeled")
        feat_maps_unlab, _ = self.uscl(feats_unlab, updated_Qs_lab, modal="unlabeled")
        return logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab, feat_maps_consis
