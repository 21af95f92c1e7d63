"""SwinUNETR 3D in PyTorch (counterpart of `icl_tpu/models/swinunetr.py`).

Convolutions run NCDHW; the Swin stages run channel-last inside, as
MONAI's SwinViT does. The module tree follows the reference key layout
(`swinViT.layers1.0.blocks.0.attn.qkv`, `encoder1.layer.conv1.conv`,
`decoder5.transp_conv.conv`, `out.conv.conv`, ...), so a state_dict in
that layout loads with `strict=True`. Window attention goes through the
fused kernels (`ops.window_attention`), forward and backward.

Train mode: `return_feats` also returns the ICL taps [dec3, dec2, dec1,
dec0]; `remat` recomputes each Swin block, UnetResBlock encoder and
UnetrUpBlock decoder in the backward (`torch.utils.checkpoint`, where the
JAX package uses `nn.remat`, swinunetr.py:303-305, :503-504).

Kept quirks of the reference: the relative-position bias table is always
(2*7-1)^3 rows and a stage whose window shrinks slices `[:N, :N]` of the
7^3 index; PatchMerging duplicates two of its eight slices.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icl_tpu_torch.models.layers import (call_remat, gelu_exact, instance_norm, layer_norm,
                                         layer_norm_no_affine)
from icl_tpu_torch.ops.window_attention import window_attention
from icl_tpu_torch.parallel.tensor import local_heads


def get_window_size_3d(dims, window, shift):
    """Per-dim shrink when dim <= window (swinunetr.py:36)."""
    ws, ss = list(window), list(shift)
    for i, d in enumerate(dims):
        if d <= window[i]:
            ws[i] = d
            ss[i] = 0
    return tuple(ws), tuple(ss)


def window_partition_3d(x: torch.Tensor, ws) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, ws0*ws1*ws2, C], windows in (b, d, h, w)
    order and tokens in (d, h, w) order."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, ws[0] * ws[1] * ws[2], C)


def window_reverse_3d(windows: torch.Tensor, ws, dims) -> torch.Tensor:
    B, D, H, W = dims
    C = windows.shape[-1]
    x = windows.view(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


def relative_position_index_3d(ws) -> np.ndarray:
    """3D pairwise relative-position index [N, N] (swinunetr.py:61)."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in ws], indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    for i in range(3):
        rel[:, :, i] += ws[i] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


def window_region_ids_3d(dims, ws, ss) -> Optional[np.ndarray]:
    """Shift-region id of each window token [nW, N] (float32), or None when
    no dim shifts (swinunetr.py:75). Keys whose id differs from the
    query's get the -100 mask."""
    if not any(s > 0 for s in ss):
        return None
    D, H, W = dims
    img_mask = np.zeros((1, D, H, W, 1), np.float32)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mw = img_mask.reshape(1, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], 1)
    return mw.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _region_ids_on(dims, ws, ss, device: torch.device) -> Optional[torch.Tensor]:
    """Region ids as a device tensor, made once per stage geometry. Made
    outside inference mode even when the first call is inside it, so that
    a later training step may save the cached tensor for its backward."""
    ids = window_region_ids_3d(dims, ws, ss)
    if ids is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(ids).to(device)


class WindowAttention3D(nn.Module):
    """3D W-MSA with relative position bias (swinunetr.py:115-179).
    `window_size` is the configured window (7^3): it sizes the bias table
    in every stage, and a stage with N < 343 tokens slices `[:N, :N]` of
    the 7^3 index. `attention` is the fused op; the plain version can be
    put in its place to compare the two. Under tensor parallelism (`tp`)
    it runs on its heads as the 2D `WindowAttention` does, with the region
    ids as they are."""

    tp = None  # a `parallel.tensor.HeadShard` under tensor parallelism

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int]):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.window_size = ws = tuple(window_size)
        table = (2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1)
        self.relative_position_bias_table = nn.Parameter(torch.empty(table, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index_3d(ws)), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.attention = window_attention

    def reset_buffers_(self) -> None:
        self.relative_position_index.copy_(torch.from_numpy(relative_position_index_3d(self.window_size)))

    def forward(self, x: torch.Tensor, region_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        table, H = local_heads(self.relative_position_bias_table, self.tp, self.num_heads)
        hd = C // self.num_heads
        qkv = self.qkv(x).view(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)
        rpi = self.relative_position_index[:N, :N].reshape(-1)
        bias = table[rpi].view(N, N, H).permute(2, 0, 1)
        bias = bias.float().contiguous()
        out = self.attention(q, k, v, bias, region_ids, scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(B_, N, H * hd))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(gelu_exact(self.linear1(x)))


class SwinBlock3D(nn.Module):
    """pad -> roll -> partition -> attention -> reverse -> roll back ->
    crop, then the MLP (swinunetr.py:321-366). The stage passes the
    effective window, the shift and, for a shifted block, the region ids."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int], mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3D(dim, num_heads, window_size)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, ws, ss, region_ids):
        B, D, Hd, W, C = x.shape
        h = self.norm1(x)
        pads = [(w - d % w) % w for d, w in zip((D, Hd, W), ws)]
        if any(pads):
            h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dp, hp, wp = h.shape[1:4]
        shifted = any(s > 0 for s in ss)
        if shifted:
            h = torch.roll(h, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        windows = window_partition_3d(h, ws)
        attn = self.attn(windows, region_ids if shifted else None)
        h = window_reverse_3d(attn, ws, (B, dp, hp, wp))
        if shifted:
            h = torch.roll(h, shifts=tuple(ss), dims=(1, 2, 3))
        x = x + h[:, :D, :Hd, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging3D(nn.Module):
    """8-neighbour concat + LN + Linear 8C->2C, with the reference's
    duplicated slices (x5 = x2, x6 = x3; swinunetr.py:369-390)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(8 * dim)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, D, H, W, C = x.shape
        if D % 2 or H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))

        def s(a, b, c):
            return x[:, a::2, b::2, c::2, :]

        parts = [s(0, 0, 0), s(1, 0, 0), s(0, 1, 0), s(0, 0, 1),
                 s(1, 0, 1), s(0, 1, 0), s(0, 0, 1), s(1, 1, 1)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class BasicLayer(nn.Module):
    """One Swin stage: a plain loop over its blocks (odd blocks shift),
    then PatchMerging. Channel-last in and out."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Sequence[int],
                 remat: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.remat = remat
        self.blocks = nn.ModuleList(SwinBlock3D(dim, num_heads, window_size) for _ in range(depth))
        self.downsample = PatchMerging3D(dim)

    def forward(self, x):
        dims = tuple(x.shape[1:4])
        ws, ss = get_window_size_3d(dims, self.window_size, tuple(w // 2 for w in self.window_size))
        padded = tuple(d + (w - d % w) % w for d, w in zip(dims, ws))
        region_ids = _region_ids_on(padded, ws, ss, x.device)
        for b, blk in enumerate(self.blocks):
            if b % 2 == 1 and region_ids is not None:
                x = call_remat(self.remat, blk, x, ws, ss, region_ids)
            else:
                x = call_remat(self.remat, blk, x, ws, (0, 0, 0), None)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=2, stride=2)


def proj_out(x_cl: torch.Tensor) -> torch.Tensor:
    """Channel-last hidden state -> LayerNorm (no affine) -> NCDHW."""
    return layer_norm_no_affine(x_cl).permute(0, 4, 1, 2, 3).contiguous()


class SwinViT3D(nn.Module):
    """MONAI-style 3D Swin encoder emitting 5 per-scale hidden states, NCDHW
    (swinunetr.py:401)."""

    def __init__(self, in_chans: int, embed_dim: int, depths: Sequence[int],
                 num_heads: Sequence[int], window_size: Sequence[int], remat: bool = False):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dim)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            layer = BasicLayer(embed_dim * 2**i, depth, heads, window_size, remat)
            self.add_module(f"layers{i + 1}", nn.ModuleList([layer]))
        self.num_layers = len(depths)

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        outs = [proj_out(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i + 1}")[0](x)
            outs.append(proj_out(x))
        return outs


class ConvOnly(nn.Module):
    """Holds one conv as `.conv` (MONAI's `Convolution` key layout)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    """conv-IN-lrelu, conv-IN, (+ 1x1 conv-IN residual when the channel
    count changes), lrelu; bias-free convs (swinunetr.py:440)."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        pad = kernel // 2
        self.conv1 = ConvOnly(nn.Conv3d(cin, features, kernel, padding=pad, bias=False))
        self.conv2 = ConvOnly(nn.Conv3d(features, features, kernel, padding=pad, bias=False))
        self.conv3 = ConvOnly(nn.Conv3d(cin, features, 1, bias=False)) if cin != features else None

    def forward(self, x):
        out = F.leaky_relu(instance_norm(self.conv1(x)), 0.01)
        out = instance_norm(self.conv2(out))
        residual = x if self.conv3 is None else instance_norm(self.conv3(x))
        return F.leaky_relu(out + residual, 0.01)


class UnetrBasicBlock(nn.Module):
    """Encoder block: a UnetResBlock under `.layer`."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.layer = UnetResBlock(cin, features)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Bias-free transposed conv 2x up, concat [up, skip], UnetResBlock
    (swinunetr.py:468-483)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.transp_conv = ConvOnly(nn.ConvTranspose3d(cin, features, 2, stride=2, bias=False))
        self.conv_block = UnetResBlock(2 * features, features)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class SwinUNETR(nn.Module):
    """Reference SwinUNETR forward graph (swinunetr.py:486-522). Input
    [B, in_chns, D, H, W], logits [B, class_num, D, H, W]; with
    `return_feats`, (logits, [dec3, dec2, dec1, dec0])."""

    def __init__(self, in_chns: int, class_num: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: Sequence[int] = (7, 7, 7),
                 return_feats: bool = False, remat: bool = False):
        super().__init__()
        fs = feature_size
        self.return_feats = return_feats
        self.remat = remat
        self.swinViT = SwinViT3D(in_chns, fs, depths, num_heads, window_size, remat)
        self.encoder1 = UnetrBasicBlock(in_chns, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = ConvOnly(ConvOnly(nn.Conv3d(fs, class_num, 1)))

    def forward(self, x):
        def run(block, *args):
            return call_remat(self.remat, block, *args)

        hs = self.swinViT(x)
        enc0 = run(self.encoder1.layer, x)
        enc1 = run(self.encoder2.layer, hs[0])
        enc2 = run(self.encoder3.layer, hs[1])
        enc3 = run(self.encoder4.layer, hs[2])
        dec4 = run(self.encoder10.layer, hs[4])
        dec3 = run(self.decoder5, dec4, hs[3])
        dec2 = run(self.decoder4, dec3, enc3)
        dec1 = run(self.decoder3, dec2, enc2)
        dec0 = run(self.decoder2, dec1, enc1)
        logits = self.out(run(self.decoder1, dec0, enc0))
        if self.return_feats:
            return logits, [dec3, dec2, dec1, dec0]
        return logits
