"""2D U-Net, channel-first (counterpart of `icl_tpu/models/unet2d.py`).

Five levels of feature channels (16, 32, 64, 128, 256); ConvBlocks of
Conv3x3 -> BN -> LeakyReLU -> Dropout -> Conv3x3 -> BN -> LeakyReLU;
max-pool downsampling; each UpBlock a conv1x1, a bilinear 2x upsample
with align_corners=True and the concat [skip, up]; a 3x3 output conv.

Kept quirk of the reference: its config asks for no bilinear upsampling,
but the Decoder never passes that on to its UpBlocks, whose default is
bilinear, so every reachable UpBlock is conv1x1 + upsample, never a
ConvTranspose (unet2d.py:10-15).

Module names follow the reference key layout (`encoder.in_conv.conv_conv.
{0,1,4,5}`, `encoder.down{i}.maxpool_conv.1.conv_conv.*`,
`decoder.up{i}.conv1x1`, `decoder.up{i}.conv.conv_conv.*`,
`decoder.out_conv`), so a state_dict in that layout loads with
`strict=True`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from icl_tpu_torch.models.layers import Dropout, batch_norm, upsample_align_corners

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


class ConvBlock(nn.Module):
    """Two Conv3x3 + BN + LeakyReLU(0.01) layers, dropout after the first
    (unet.py:32-48); `conv_conv` indices 0 conv, 1 BN, 4 conv, 5 BN."""

    def __init__(self, cin: int, cout: int, dropout_p: float):
        super().__init__()
        self.conv_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), batch_norm(cout, 2), nn.LeakyReLU(0.01),
            Dropout(dropout_p),
            nn.Conv2d(cout, cout, 3, padding=1), batch_norm(cout, 2), nn.LeakyReLU(0.01))

    def forward(self, x):
        return self.conv_conv(x)


class DownBlock(nn.Module):
    """MaxPool(2) then a ConvBlock (`maxpool_conv.1`; the pool is the
    counterpart of `max_pool`, layers.py:185-189)."""

    def __init__(self, cin: int, cout: int, dropout_p: float):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), ConvBlock(cin, cout, dropout_p))

    def forward(self, x):
        return self.maxpool_conv(x)


class UpBlock(nn.Module):
    """conv1x1 to the skip's channels `cout`, bilinear 2x upsample
    (align_corners=True), concat [skip, up], ConvBlock without dropout
    (unet.py:66-87)."""

    def __init__(self, cin_deep: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin_deep, cout, 1)
        self.conv = ConvBlock(2 * cout, cout, 0.0)

    def forward(self, x_deep, x_skip):
        x_up = upsample_align_corners(self.conv1x1(x_deep), 2)
        return self.conv(torch.cat([x_skip, x_up], dim=1))


class Encoder(nn.Module):
    """Five levels (unet.py:90-117)."""

    def __init__(self, in_chns: int, features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        ft, dp = features, dropout
        self.in_conv = ConvBlock(in_chns, ft[0], dp[0])
        self.down1 = DownBlock(ft[0], ft[1], dp[1])
        self.down2 = DownBlock(ft[1], ft[2], dp[2])
        self.down3 = DownBlock(ft[2], ft[3], dp[3])
        self.down4 = DownBlock(ft[3], ft[4], dp[4])

    def forward(self, x):
        x0 = self.in_conv(x)
        x1 = self.down1(x0)
        x2 = self.down2(x1)
        x3 = self.down3(x2)
        return [x0, x1, x2, x3, self.down4(x3)]


class Decoder(nn.Module):
    """The symmetric decoder and its 3x3 output conv (unet.py:120-154).
    With `return_feats` it also returns the taps [x_1, x_2, x_3] that feed
    the ICL heads (unet_icl.py:180-194)."""

    def __init__(self, class_num: int, features: Sequence[int] = DEFAULT_FEATURES,
                 return_feats: bool = False):
        super().__init__()
        ft = features
        self.return_feats = return_feats
        self.up1 = UpBlock(ft[4], ft[3])
        self.up2 = UpBlock(ft[3], ft[2])
        self.up3 = UpBlock(ft[2], ft[1])
        self.up4 = UpBlock(ft[1], ft[0])
        self.out_conv = nn.Conv2d(ft[0], class_num, 3, padding=1)

    def forward(self, feature):
        x0, x1, x2, x3, x4 = feature
        x_1 = self.up1(x4, x3)
        x_2 = self.up2(x_1, x2)
        x_3 = self.up3(x_2, x1)
        output = self.out_conv(self.up4(x_3, x0))
        if self.return_feats:
            return output, [x_1, x_2, x_3]
        return output


class UNet(nn.Module):
    """The plain 2D U-Net (unet.py:305-322): logits [B, classes, H, W]."""

    def __init__(self, in_chns: int, class_num: int):
        super().__init__()
        self.encoder = Encoder(in_chns)
        self.decoder = Decoder(class_num)

    def forward(self, x):
        return self.decoder(self.encoder(x))
