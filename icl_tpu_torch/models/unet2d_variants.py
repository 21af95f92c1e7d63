"""The semi-supervised baselines' 2D U-Net variants (counterpart of
`icl_tpu/models/unet2d_variants.py`, the reference's unet.py:157-391):
UNet_CCT (a shared encoder, a main decoder and three decoders on perturbed
features), UNet_URPC (deep supervision with the stage features perturbed
in training) and UNet_DS (deep supervision), registry keys `unet_cct`,
`unet_urpc` and `unet_ds`.

The perturbations (unet.py:273-302) draw from the module's `generator`
(None: torch's default generator of the tensor's device); `perturb =
False` makes them the identity, for a step another framework can match.
Module names follow the JAX package's parameter tree, which
`utils/convert.py` carries over (`unet_cct_state_dict_from_jax`,
`unet_ds_state_dict_from_jax`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from icl_tpu_torch.models.unet2d import DEFAULT_FEATURES, Decoder, Encoder, UpBlock


def feature_dropout(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """FeatureDropout (unet.py:278-286): zero the positions whose mean over
    channels reaches a fraction U(0.7, 0.9) of its largest value in the
    sample (one fraction for the batch), the most salient ones."""
    attention = x.mean(dim=1, keepdim=True)
    max_val = attention.flatten(1).amax(dim=1)
    frac = torch.empty((), device=x.device).uniform_(0.7, 0.9, generator=generator)
    threshold = (max_val * frac).view(-1, 1, 1, 1)
    return x * (attention < threshold).to(x.dtype)


def feature_noise(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  uniform_range: float = 0.3) -> torch.Tensor:
    """FeatureNoise (unet.py:289-302): x * U(-r, r) + x, the noise shared
    across the batch."""
    noise = torch.empty(x.shape[1:], device=x.device, dtype=x.dtype).uniform_(
        -uniform_range, uniform_range, generator=generator)
    return x * noise[None] + x


def dropout_perturb(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                    p: float = 0.3) -> torch.Tensor:
    """Element-wise dropout at rate `p`, kept values scaled by 1 / (1 - p)."""
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


class UNetCCT(nn.Module):
    """UNet_CCT (unet.py:324-349): in training (main, aux1, aux2, aux3),
    the aux decoders fed the encoder's features with feature noise,
    dropout and feature dropout; else the main decoder's logits."""

    def __init__(self, in_chns: int, class_num: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.main_decoder = Decoder(class_num)
        self.aux_decoder1 = Decoder(class_num)
        self.aux_decoder2 = Decoder(class_num)
        self.aux_decoder3 = Decoder(class_num)
        self.generator = generator
        self.perturb = True

    def forward(self, x, *, inference: bool = False):
        feature = self.encoder(x)
        main_seg = self.main_decoder(feature)
        if inference or not self.training:
            return main_seg
        aux = []
        for perturbation in (feature_noise, dropout_perturb, feature_dropout):
            feats = [perturbation(f, self.generator) if self.perturb else f for f in feature]
            aux.append(feats)
        return (main_seg, self.aux_decoder1(aux[0]), self.aux_decoder2(aux[1]),
                self.aux_decoder3(aux[2]))


class DecoderDS(nn.Module):
    """Decoder_DS / Decoder_URPC (unet.py:157-270): a 3x3 head after each
    of the first three up blocks, upsampled (nearest) to the input's size,
    beside the output conv; with `urpc`, in training, the heads see the
    stage features after dropout (0.5), feature dropout and feature noise."""

    def __init__(self, class_num: int, urpc: bool = False,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ft = features
        self.up1 = UpBlock(ft[4], ft[3])
        self.up2 = UpBlock(ft[3], ft[2])
        self.up3 = UpBlock(ft[2], ft[1])
        self.up4 = UpBlock(ft[1], ft[0])
        self.out_conv = nn.Conv2d(ft[0], class_num, 3, padding=1)
        self.out_conv_dp3 = nn.Conv2d(ft[3], class_num, 3, padding=1)
        self.out_conv_dp2 = nn.Conv2d(ft[2], class_num, 3, padding=1)
        self.out_conv_dp1 = nn.Conv2d(ft[1], class_num, 3, padding=1)
        self.urpc = urpc
        self.generator = generator
        self.perturb = True

    def forward(self, feature, shape):
        x0, x1, x2, x3, x4 = feature
        perturb = self.urpc and self.training and self.perturb
        g = self.generator

        def head(conv, h):
            # torch's "nearest" (the reference's F.interpolate default) is
            # jax.image.resize "nearest" at the integer factors used here
            return F.interpolate(conv(h), size=tuple(shape), mode="nearest")

        x = self.up1(x4, x3)
        dp3 = head(self.out_conv_dp3, dropout_perturb(x, g, 0.5) if perturb else x)
        x = self.up2(x, x2)
        dp2 = head(self.out_conv_dp2, feature_dropout(x, g) if perturb else x)
        x = self.up3(x, x1)
        dp1 = head(self.out_conv_dp1, feature_noise(x, g) if perturb else x)
        dp0 = self.out_conv(self.up4(x, x0))
        return dp0, dp1, dp2, dp3


class UNetDS(nn.Module):
    """UNet_DS (unet.py:373-391): (dp0, dp1, dp2, dp3) at the input's size,
    in training and in eval."""

    urpc = False

    def __init__(self, in_chns: int, class_num: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.decoder = DecoderDS(class_num, urpc=self.urpc, generator=generator)

    def forward(self, x, *, inference: bool = False):
        return self.decoder(self.encoder(x), x.shape[2:])


class UNetURPC(UNetDS):
    """UNet_URPC (unet.py:352-370): UNet_DS with the perturbed heads."""

    urpc = True
