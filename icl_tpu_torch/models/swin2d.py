"""Swin-UNet 2D in PyTorch (counterpart of `icl_tpu/models/swin2d.py`):
a Swin-T encoder and a symmetric Swin decoder with skip concatenation,
PatchExpand upsampling, FinalPatchExpand_X4 and a 1x1 conv head.

The input and the logits are NCHW; the Swin stages run on grid tokens
[B, H, W, C] inside, as the JAX package does. The module tree follows the
reference `SwinTransformerSys` key layout that `swinunet2d_full_key_table`
spells (`patch_embed.proj`, `layers.{i}.blocks.{b}.attn.qkv`,
`layers.{i}.downsample.reduction`, `layers_up.0.expand`,
`concat_back_dim.{i}`, `layers_up.{i}.upsample.expand`, `up.expand`,
`output`, ...), and registers the same buffers as the reference:
`attn.relative_position_index` in every block and `attn_mask` in each
shifted block. So a state_dict in that layout, buffers included, loads with
`strict=True`.

Window attention goes through the fused op (`ops.window_attention`) in
every block, for every window size: the unshifted blocks with no mask, the
shifted ones with their dense `attn_mask` [nW, N, N] (the kernels' MASK
mode, `_kernel_masked` in the JAX package). The JAX package sends only
N >= 128 to its Pallas kernel (swin2d.py:152-156), a TPU timing that does
not carry over. On CPU tensors the op runs its plain version, which is the
einsum the JAX package runs there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from icl_tpu_torch.models.icl import MLP
from icl_tpu_torch.models.layers import DropPath, layer_norm
from icl_tpu_torch.ops.window_attention import window_attention
from icl_tpu_torch.parallel.tensor import local_heads


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C], windows in (b, h, w) order."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    C = windows.shape[-1]
    x = windows.view(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def relative_position_index_2d(ws: int) -> np.ndarray:
    """Pairwise relative-position index [N, N] of a ws x ws window
    (swin2d.py:94)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Additive attention mask [nW, N, N] (0 / -100) of the shifted windows
    of an H x W grid (swin2d.py:107)."""
    img_mask = np.zeros((H, W), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    mw = img_mask.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (swin2d.py:123-172). `attention`
    is the fused op; the plain version can be put in its place to compare
    the two. On heads [start, stop) of a model group (`tp`, set by
    `parallel.mesh.shard_model`) `qkv` holds those heads' q, k and v rows,
    `proj` their input columns (row-parallel), the op runs on the local
    heads with their columns of the bias table (read through
    `copy_to_model`, so that its gradient is summed over the model group),
    and a dense mask [nW, N, N] as it is."""

    tp = None  # a `parallel.tensor.HeadShard` under tensor parallelism

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window_size - 1) ** 2,
                                                                     num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index_2d(window_size)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attention = window_attention

    def reset_buffers_(self) -> None:
        self.relative_position_index.copy_(torch.from_numpy(relative_position_index_2d(self.window_size)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        table, H = local_heads(self.relative_position_bias_table, self.tp, self.num_heads)
        hd = C // self.num_heads
        q, k, v = (t.contiguous() for t in self.qkv(x).view(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4))
        bias = table[self.relative_position_index.view(-1)]
        bias = bias.view(N, N, H).permute(2, 0, 1).float().contiguous()
        out = self.attention(q, k, v, bias, mask=mask, scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(B_, N, H * hd))


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual + drop path -> LN ->
    MLP (swin2d.py:175-220) on grid tokens [B, H, W, C]. A grid no larger
    than the window takes one unshifted window of its size (:191)."""

    def __init__(self, dim: int, input_resolution: Sequence[int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        H, W = input_resolution
        if min(H, W) <= window_size:
            window_size, shift_size = min(H, W), 0
        self.input_resolution = (H, W)
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim)
        self.register_buffer("attn_mask", self._mask() if shift_size > 0 else None)

    def _mask(self) -> torch.Tensor:
        return torch.from_numpy(shifted_window_mask(*self.input_resolution, self.window_size,
                                                    self.shift_size))

    def reset_buffers_(self) -> None:
        if self.attn_mask is not None:
            self.attn_mask.copy_(self._mask())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.input_resolution
        ws, shift = self.window_size, self.shift_size
        h = self.norm1(x)
        if shift:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        h = window_reverse(self.attn(window_partition(h, ws), self.attn_mask), ws, H, W)
        if shift:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        x = x + self.drop_path(h)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat, LN, Linear 4C -> 2C (swin2d.py:223)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """Linear C -> 2C and a 2x pixel shuffle to C/2 channels (PatchExpand,
    swin2d.py:240), or with `scale` 4, Linear C -> 16C and a 4x pixel
    shuffle to C channels (FinalPatchExpand_X4, :254); then LN."""

    def __init__(self, dim: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.out_dim = dim if scale == 4 else dim // 2
        self.expand = nn.Linear(dim, scale * scale * self.out_dim, bias=False)
        self.norm = layer_norm(self.out_dim)

    def forward(self, x):
        B, H, W, _ = x.shape
        s, c = self.scale, self.out_dim
        x = self.expand(x).view(B, H, W, s, s, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, H * s, W * s, c))


class BasicLayer(nn.Module):
    """The blocks of one stage (odd blocks shift by half a window), then
    `downsample` (encoder) or `upsample` (decoder) where the stage has one."""

    def __init__(self, dim: int, resolution: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, drop_path: Sequence[float],
                 downsample: bool = False, upsample: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, (resolution, resolution), num_heads, window_size,
                      0 if b % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias, drop_path[b])
            for b in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)
        if upsample:
            self.upsample = PatchExpand(dim)

    def run_blocks(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """The geometry of `configs/swin_tiny_patch4_window7_224_lite.yaml`
    (swin2d.py:268)."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 2, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.2
    patch_norm: bool = True
    ape: bool = False  # read from the yaml, unused: the JAX model has no absolute embedding


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        if cfg.patch_norm:
            self.norm = layer_norm(cfg.embed_dim)

    def forward(self, x):
        x = self.proj(x).permute(0, 2, 3, 1)
        return self.norm(x) if hasattr(self, "norm") else x


class SwinUNet2D(nn.Module):
    """`SwinTransformerSys` (swin2d.py:289-365). Input [B, in_chans, img,
    img], logits [B, num_classes, img, img]; with `return_feats`, (logits,
    the decoder taps [B, L, C] of layers_up 1..3), the ICL heads' inputs."""

    def __init__(self, num_classes: int, cfg: SwinConfig = SwinConfig(), return_feats: bool = False):
        super().__init__()
        self.cfg = cfg
        self.return_feats = return_feats
        n = len(cfg.depths)
        pr = cfg.img_size // cfg.patch_size
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()

        def stage(i, **kw):
            dp = dpr[sum(cfg.depths[:i]):sum(cfg.depths[:i + 1])]
            return BasicLayer(cfg.embed_dim * 2**i, pr // 2**i, cfg.depths[i], cfg.num_heads[i],
                              cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias, dp, **kw)

        self.patch_embed = PatchEmbed(cfg)
        self.layers = nn.ModuleList(stage(i, downsample=i < n - 1) for i in range(n))
        self.norm = layer_norm(cfg.embed_dim * 2 ** (n - 1))
        self.layers_up = nn.ModuleList(
            [PatchExpand(cfg.embed_dim * 2 ** (n - 1))]
            + [stage(n - 1 - i, upsample=i < n - 1) for i in range(1, n)])
        self.concat_back_dim = nn.ModuleList(
            [nn.Identity()] + [nn.Linear(2 * cfg.embed_dim * 2 ** (n - 1 - i),
                                         cfg.embed_dim * 2 ** (n - 1 - i)) for i in range(1, n)])
        self.norm_up = layer_norm(cfg.embed_dim)
        self.up = PatchExpand(cfg.embed_dim, scale=4)
        self.output = nn.Conv2d(cfg.embed_dim, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer.run_blocks(x)
            if hasattr(layer, "downsample"):
                x = layer.downsample(x)
        x = self.layers_up[0](self.norm(x))
        feats = []
        for i in range(1, len(self.layers_up)):
            layer = self.layers_up[i]
            x = self.concat_back_dim[i](torch.cat([x, skips[-1 - i]], -1))
            x = layer.run_blocks(x)
            feats.append(x.flatten(1, 2))  # ICL tap [B, L, C]
            if hasattr(layer, "upsample"):
                x = layer.upsample(x)
        x = self.up(self.norm_up(x))
        out = self.output(x.permute(0, 3, 1, 2))
        return (out, feats) if self.return_feats else out


def expand_gray(x: torch.Tensor) -> torch.Tensor:
    """A one-channel image repeated to the 3 channels the Swin patch embed
    takes (swin2d.py:382)."""
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


class SwinUnetWrapper(nn.Module):
    """The non-ICL SwinUnet (swin2d.py:368-386): grayscale -> 3 channels,
    then `swin_unet`. What the ICL model runs at inference, so its best
    checkpoint (ICL heads stripped) loads here strictly. A full `cfg` wins
    over `img_size` and `window_size`."""

    def __init__(self, in_chns: int, class_num: int, img_size: int = 224, window_size: int = 7,
                 cfg: Optional[SwinConfig] = None):
        super().__init__()
        cfg = cfg or SwinConfig(img_size=img_size, window_size=window_size)
        self.swin_unet = SwinUNet2D(class_num, cfg)

    def forward(self, x):
        return self.swin_unet(expand_gray(x))
