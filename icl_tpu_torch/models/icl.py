"""Inherent Consistent Learning heads (SSPA / USCL) in PyTorch,
channel-first (counterpart of `icl_tpu/models/icl.py`): 3D as SwinUNETR-ICL
uses them, 2D as the U-Net-ICL uses them, and the tokenized 2D variant of
Swin-UNet-ICL.

Module names follow the reference key layout (`guide_Q` in SwinUNETR-ICL,
`guided_Q` in Swin-UNet-ICL, `proj_layers.{i}`, `norm_layers.{i}`,
`class_decoders.{i}.attn.fc_q`, `attn_convs0.{i}.block.depthwise`,
`attn_convs1.{i}`, `query_convs.{i}`), so a state_dict in that layout
loads with `strict=True`.

Kept quirks of the reference:
  * `QueryAttention` reshapes the projected query [B, cls, C] straight to
    [B, heads, cls, C/heads] and the attended value straight back, so
    heads interleave class and channel (icl.py:72-82);
  * `ClassDecoder` adds a self-residual q = q_out + drop_path(q_out) and
    runs `mlp2` over the pre-softmax attention map (icl.py:104-118);
  * the learned query starts at zero, and every scale uses the drop-path
    rate dpr[1] (icl.py:190-199).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icl_tpu_torch.models.layers import DropPath, batch_norm, gelu_exact, layer_norm, torch_default_init_
from icl_tpu_torch.parallel.collectives import global_mean
from icl_tpu_torch.parallel.tensor import gather_from_model, scatter_to_model


class MLP(nn.Module):
    """fc1 -> GELU -> fc2 (icl.py:41-53)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class QueryAttention(nn.Module):
    """Cross-attention from class queries to feature tokens that also
    returns the pre-softmax logits (icl.py:56-85).

    On heads [start, stop) of a model group (`tp`, set by
    `parallel.mesh.shard_model`): `fc_q` and `fc_kv` are column-parallel,
    `fc_kv` on its heads' k and v rows, `proj` row-parallel. The straight
    reshapes interleave class and channel, so a block of `fc_q`'s output
    channels is not a set of heads: its output is gathered, reshaped and
    this rank's heads taken; the attended values are gathered over the
    heads before the straight reshape back and `proj` takes this rank's
    block of its columns. The logits feed `mlp2`, which needs every row,
    and `attn_convs0`, whose channels are the heads: they are gathered
    over the heads too."""

    tp = None  # a `parallel.tensor.HeadShard` under tensor parallelism

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.fc_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.fc_kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, x):
        B, N, C = x.shape
        num_classes = q.shape[1]
        H = self.num_heads
        head_dim = C // H
        mesh, heads = (None, H) if self.tp is None else (self.tp.mesh, self.tp.heads)
        q = gather_from_model(self.fc_q(q), -1, mesh)  # [B, cls, C]
        # straight reshape (quirk), then this rank's heads
        q = scatter_to_model(q.reshape(B, H, num_classes, head_dim), 1, mesh)
        k, v = self.fc_kv(x).reshape(B, N, 2, heads, head_dim).permute(2, 0, 3, 1, 4)
        attn1 = torch.einsum("bhcd,bhnd->bhcn", q, k) * head_dim**-0.5  # [B, H / M, cls, N]
        out = gather_from_model(torch.einsum("bhcn,bhnd->bhcd", attn1.softmax(-1), v), 1, mesh)
        # straight reshape back (quirk), then this rank's block of proj's columns
        out = self.proj(scatter_to_model(out.reshape(B, num_classes, C), -1, mesh))
        return out, gather_from_model(attn1, 1, mesh).transpose(1, 2)  # [B, cls, H, N] logits


class ClassDecoder(nn.Module):
    """Pre-norm cross-attention over the class queries; the attention map
    gets a LayerNorm(N) + MLP(N) residual (icl.py:88-119)."""

    def __init__(self, dim: int, n_patch: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.norm1_query = layer_norm(dim)
        self.attn = QueryAttention(dim, num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim)
        self.norm3 = layer_norm(n_patch)
        self.mlp2 = MLP(n_patch, n_patch, n_patch)

    def forward(self, query, feat):
        dp = self.drop_path
        q_out, attn = self.attn(self.norm1_query(query), self.norm1(feat))
        query = q_out + dp(q_out)  # self-residual (quirk)
        query = query + dp(self.mlp(self.norm2(query)))
        attn = attn + dp(attn)
        attn = attn + dp(self.mlp2(self.norm3(attn)))
        return query, attn


class SeparableConv(nn.Module):
    """Depthwise 3^d conv, BN, ReLU, pointwise conv, BN, ReLU, no biases
    (icl.py:122-146); its modules sit under `.block` as in the reference."""

    def __init__(self, cin: int, features: int, spatial_dims: int = 3):
        super().__init__()
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[spatial_dims]
        self.block = nn.ModuleDict({
            "depthwise": conv(cin, cin, 3, padding=1, groups=cin, bias=False),
            "bn_depth": batch_norm(cin, spatial_dims),
            "pointwise": conv(cin, features, 1, bias=False),
            "bn_point": batch_norm(features, spatial_dims),
        })

    def forward(self, x):
        b = self.block
        x = F.relu(b["bn_depth"](b["depthwise"](x)))
        return F.relu(b["bn_point"](b["pointwise"](x)))


class InherentConsistent(nn.Module):
    """Multi-scale class-decoder head (icl.py:149-268).

    feats: channel-first maps [B, C_i, *spatial_i] (at least len(depths)
    of them; the rest are ignored), or with `tokenized_input` tokens
    [B, N_i, C_i] that go to the class decoder as they are, with no proj
    conv and no norm (the Swin-UNet 2D variant; it has neither module,
    icl.py:210-214). In 'labeled' mode the learned query (named
    `query_name`) seeds scale 0 and a pointwise projection halves it for
    the next scale; in 'unlabeled' mode each scale's query is
    `guided_Q[i]`, taken from the labeled pass. Returns (feat_maps,
    updated_Qs): class maps [B, cls, *spatial_i] and batch-mean queries
    [1, cls, C_i], the mean over the global batch under data parallelism
    (`parallel.collectives.global_mean`), as in the JAX package.

    `pair_split` (labeled mode only): `feats` are the two labeled-mode
    calls' inputs concatenated along the batch, the first `pair_split`
    samples from the labeled branch (`sspa_paired`). Every op up to the
    attention map is per sample; the BatchNorm-bearing SeparableConv runs
    once per branch (each its own batch stats, running stats updated
    labeled first, as the two calls do), and updated_Qs average the
    labeled samples only (icl.py:244-252).
    """

    def __init__(self, in_chans: Sequence[int], num_classes: int, num_heads: Sequence[int],
                 input_resolution: Sequence[int], spatial_dims: int = 3,
                 depths: Sequence[int] = (2, 2, 2), drop_path_rate: float = 0.1,
                 tokenized_input: bool = False, query_name: str = "guide_Q"):
        super().__init__()
        self.in_chans = tuple(in_chans)
        self.num_classes = num_classes
        self.input_resolution = tuple(input_resolution)
        self.spatial_dims = spatial_dims
        self.num_scales = len(depths)
        # every scale uses dpr[1] (icl.py:190-193)
        drop_path = float(np.linspace(0.0, drop_path_rate, sum(depths))[1])
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[spatial_dims]
        scales = range(self.num_scales)
        self.tokenized_input = tokenized_input
        self.query_name = query_name
        self.register_parameter(query_name, nn.Parameter(torch.zeros(1, num_classes, self.in_chans[0])))
        if not tokenized_input:
            self.proj_layers = nn.ModuleList(conv(in_chans[i], in_chans[i], 1) for i in scales)
            self.norm_layers = nn.ModuleList(layer_norm(in_chans[i]) for i in scales)
        self.class_decoders = nn.ModuleList(
            ClassDecoder(in_chans[i], input_resolution[i] ** spatial_dims, num_heads[i],
                         drop_path=drop_path) for i in scales)
        self.attn_convs0 = nn.ModuleList(
            SeparableConv(num_heads[i], num_heads[i], spatial_dims) for i in scales)
        self.attn_convs1 = nn.ModuleList(conv(num_heads[i], 1, 1) for i in scales)
        # Conv1d k=1 over the class axis, applied as a per-class linear map
        self.query_convs = nn.ModuleList(nn.Conv1d(in_chans[i], in_chans[i] // 2, 1) for i in scales)

    def init_weights_(self, generator: torch.Generator) -> None:
        """torch's default init from `generator` (the JAX package's
        TorchConv / TorchDense), unit norms, fresh BN stats, zero query."""
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
                torch_default_init_(m, generator)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d, nn.BatchNorm3d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                    m.reset_running_stats()
        nn.init.zeros_(getattr(self, self.query_name))

    def forward(self, feats, guided_Q: Optional[Sequence[torch.Tensor]] = None,
                modal: str = "labeled", pair_split: Optional[int] = None):
        if modal not in ("labeled", "unlabeled"):
            raise ValueError(f"modal {modal!r}: want 'labeled' or 'unlabeled'")
        if pair_split is not None and modal != "labeled":
            raise ValueError("pair_split is for the labeled mode only")
        BS = feats[0].shape[0]
        ncls = self.num_classes
        next_Q = getattr(self, self.query_name).expand(BS, ncls, self.in_chans[0])
        feat_maps, updated_Qs = [], []
        for i in range(self.num_scales):
            C = self.in_chans[i]
            if self.tokenized_input:
                tok = feats[i].reshape(BS, -1, C)
            else:
                tok = self.proj_layers[i](feats[i]).flatten(2).transpose(1, 2)  # [B, N, C]
                tok = self.norm_layers[i](tok)
            q_in = next_Q if modal == "labeled" else guided_Q[i].expand(BS, ncls, C)
            updated_Q, attn = self.class_decoders[i](q_in, tok)
            # [B, cls, H, N] -> [B*cls, H, *spatial]
            bs, _, nheads, _ = attn.shape
            spatial = (self.input_resolution[i],) * self.spatial_dims
            attn = attn.reshape(bs * ncls, nheads, *spatial)
            conv0 = self.attn_convs0[i]
            if pair_split is None:
                attn = conv0(attn)
            else:  # rows are sample-major: the labeled branch's come first
                s = pair_split * ncls
                attn = torch.cat([conv0(attn[:s]), conv0(attn[s:])])
            feat_maps.append(self.attn_convs1[i](attn).reshape(bs, ncls, *spatial))
            qc = self.query_convs[i]
            next_Q = F.linear(updated_Q, qc.weight[..., 0], qc.bias)
            updated_Qs.append(global_mean(updated_Q[:pair_split], 0, keepdim=True))
        return feat_maps, updated_Qs


def sspa_paired(sspa: InherentConsistent, feats_lab, feats_unlab):
    """The two labeled-mode `sspa` calls of an ICL model (on the labeled
    and on the unlabeled taps, through the same weights) as one batched
    call, so the class decoders' weights are read once (icl.py:271-284).
    Returns (feat_maps_lab, feat_maps_consis, updated_Qs_lab), the tensors
    the two calls give (the second call's queries are discarded)."""
    b_lab = feats_lab[0].shape[0]
    feats = [torch.cat([a, b]) for a, b in zip(feats_lab, feats_unlab)]
    fm_pair, updated_Qs_lab = sspa(feats, modal="labeled", pair_split=b_lab)
    return [fm[:b_lab] for fm in fm_pair], [fm[b_lab:] for fm in fm_pair], updated_Qs_lab
