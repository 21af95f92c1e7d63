"""3D U-Net, channel-first (counterpart of `icl_tpu/models/unet3d.py`).

Filters (16, 32, 64, 128, 256); ConvBlock3D of two Conv3x3x3 +
InstanceNorm + ReLU layers; max-pool downsampling; each UpBlock3D a
trilinear 2x upsample on the half-pixel grid (align_corners=False, as
`jax.image.resize(..., "linear")` samples), the concat [skip, up] and a
ConvBlock3D; dropout 0.3 after the center and after the last up stage; a
1x1x1 output conv. Convs take kaiming-normal weights N(0, 2 / fan_in) and
U(+-1/sqrt(fan_in)) biases (`kaiming_normal_kernel_init`, unet3d.py:23).

Module names follow the reference key layout (`conv1.conv1.0.weight`,
`up_concat4.conv.conv2.0.bias`, `final.weight`; the InstanceNorm has no
parameters), so a state_dict in that layout loads with `strict=True`.

`remat` recomputes each ConvBlock3D and UpBlock3D in the backward (the
JAX package recomputes the whole loss function instead, steps.py:67-70,
which in eager PyTorch would keep every activation of the recompute
alive at once and save nothing). The dropouts sit between the recomputed
blocks, never inside one, so a recompute draws no mask: the backward
sees the forward's masks whatever generator the dropouts draw from.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from icl_tpu_torch.models.layers import Dropout, call_remat, instance_norm, resize_linear

DEFAULT_FILTERS_3D = (16, 32, 64, 128, 256)


class KaimingConv3d(nn.Conv3d):
    """A Conv3d whose `init_weights_` draws the reference's kaiming init
    (`init_weights_` in layers.py calls it after the torch-default
    modules, in module order)."""

    def init_weights_(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.weight.shape[1:])
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / fan_in), generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        nn.init.uniform_(self.bias, -bound, bound, generator=generator)


class InstanceNorm(nn.Module):
    """InstanceNorm without affine or running stats (no state)."""

    def forward(self, x):
        return instance_norm(x)


class ConvBlock3D(nn.Module):
    """UnetConv3: (Conv3^3 -> InstanceNorm -> ReLU) x 2 (unet3d.py:41-58);
    `conv{1,2}` Sequentials with the conv at index 0."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Sequential(KaimingConv3d(cin, features, 3, padding=1), InstanceNorm(),
                                   nn.ReLU())
        self.conv2 = nn.Sequential(KaimingConv3d(features, features, 3, padding=1),
                                   InstanceNorm(), nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UpBlock3D(nn.Module):
    """UnetUp3_CT: trilinear 2x upsample (half-pixel grid), concat [skip,
    up], ConvBlock3D (unet3d.py:61-74). The upsample is `resize_linear`,
    one matmul per axis, whose backward repeats bit for bit on the card;
    F.interpolate's trilinear backward adds with atomics there."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = ConvBlock3D(cin, features)

    def forward(self, x_skip, x_deep):
        up = resize_linear(x_deep, [2 * n for n in x_deep.shape[2:]], align_corners=False)
        return self.conv(torch.cat([x_skip, up], dim=1))


class UNet3D(nn.Module):
    """The plain 3D U-Net (unet3d.py:80-114): logits [B, classes, D, H, W].
    With `return_feats` it returns (logits, [center (after dropout), up4,
    up3]), the taps of the ICL heads."""

    def __init__(self, in_chns: int, class_num: int, filters: Sequence[int] = DEFAULT_FILTERS_3D,
                 return_feats: bool = False, remat: bool = False, dropout: float = 0.3):
        super().__init__()
        ft = filters
        self.return_feats = return_feats
        self.remat = remat
        self.conv1 = ConvBlock3D(in_chns, ft[0])
        self.conv2 = ConvBlock3D(ft[0], ft[1])
        self.conv3 = ConvBlock3D(ft[1], ft[2])
        self.conv4 = ConvBlock3D(ft[2], ft[3])
        self.center = ConvBlock3D(ft[3], ft[4])
        self.up_concat4 = UpBlock3D(ft[3] + ft[4], ft[3])
        self.up_concat3 = UpBlock3D(ft[2] + ft[3], ft[2])
        self.up_concat2 = UpBlock3D(ft[1] + ft[2], ft[1])
        self.up_concat1 = UpBlock3D(ft[0] + ft[1], ft[0])
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.final = KaimingConv3d(ft[0], class_num, 1)

    def forward(self, x):
        def block(module, *args):
            return call_remat(self.remat, module, *args)

        conv1 = block(self.conv1, x)
        conv2 = block(self.conv2, F.max_pool3d(conv1, 2))
        conv3 = block(self.conv3, F.max_pool3d(conv2, 2))
        conv4 = block(self.conv4, F.max_pool3d(conv3, 2))
        center = self.dropout1(block(self.center, F.max_pool3d(conv4, 2)))
        up4 = block(self.up_concat4, conv4, center)
        up3 = block(self.up_concat3, conv3, up4)
        up2 = block(self.up_concat2, conv2, up3)
        up1 = self.dropout2(block(self.up_concat1, conv1, up2))
        final = self.final(up1)
        if self.return_feats:
            return final, [center, up4, up3]
        return final
