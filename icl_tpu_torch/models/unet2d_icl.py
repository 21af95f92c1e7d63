"""ICL-instrumented 2D U-Net (counterpart of `icl_tpu/models/unet2d_icl.py`).

A U-Net whose decoder also returns its taps [x_1, x_2, x_3], and two
`InherentConsistent` heads `sspa` and `uscl` on them: in_chans (128, 64,
32), heads (8, 4, 2), resolutions (P/8, P/4, P/2) for patch side P, the
query spelled `guided_Q`. The labeled and unlabeled sub-batches run as two
passes through the shared weights, each with its own BatchNorm batch
stats. A state_dict with the `sspa.` and `uscl.` keys removed loads
strictly into `UNet`.
"""
from __future__ import annotations

from torch import nn

from icl_tpu_torch.models.icl import InherentConsistent, sspa_paired
from icl_tpu_torch.models.unet2d import DEFAULT_DROPOUT, DEFAULT_FEATURES, Decoder, Encoder


class UNetICL(nn.Module):
    """`fuse_sspa_pair` runs the two labeled-mode `sspa` calls as one
    (`sspa_paired`). `zero_stochastic` turns dropout and drop path off and
    keeps the BatchNorm updates: a step that another framework can match
    (unet2d_icl.py:29-33)."""

    def __init__(self, in_chns: int, class_num: int, patch_size: int = 256,
                 fuse_sspa_pair: bool = False, zero_stochastic: bool = False):
        super().__init__()
        ft = DEFAULT_FEATURES
        self.fuse_sspa_pair = fuse_sspa_pair
        self.encoder = Encoder(in_chns, dropout=(0.0,) * 5 if zero_stochastic else DEFAULT_DROPOUT)
        self.decoder = Decoder(class_num, return_feats=True)
        icl_kwargs = dict(
            in_chans=(ft[3], ft[2], ft[1]),
            num_classes=class_num,
            num_heads=(8, 4, 2),
            input_resolution=(patch_size // 8, patch_size // 4, patch_size // 2),
            spatial_dims=2,
            drop_path_rate=0.0 if zero_stochastic else 0.1,
            query_name="guided_Q",
        )
        self.sspa = InherentConsistent(**icl_kwargs)
        self.uscl = InherentConsistent(**icl_kwargs)

    def forward(self, x_lab, x_unlab=None, *, inference: bool = False):
        """Logits alone for inference or without an unlabeled batch; else
        (logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab,
        feat_maps_consis) (unet2d_icl.py:55-81)."""
        if inference or x_unlab is None:
            return self.decoder(self.encoder(x_lab))[0]
        logits_lab, feats_lab = self.decoder(self.encoder(x_lab))
        logits_unlab, feats_unlab = self.decoder(self.encoder(x_unlab))
        if self.fuse_sspa_pair:
            feat_maps_lab, feat_maps_consis, updated_Qs_lab = sspa_paired(
                self.sspa, feats_lab, feats_unlab)
        else:
            feat_maps_lab, updated_Qs_lab = self.sspa(feats_lab, modal="labeled")
            feat_maps_consis, _ = self.sspa(feats_unlab, modal="labeled")
        feat_maps_unlab, _ = self.uscl(feats_unlab, updated_Qs_lab, modal="unlabeled")
        return logits_lab, logits_unlab, feat_maps_lab, feat_maps_unlab, feat_maps_consis
