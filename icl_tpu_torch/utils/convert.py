"""Carry SwinUNETR weights from the JAX package's parameter tree to the
port's state_dict (the reference key layout).

Input: the JAX SwinUNETR params as a nested dict of numpy arrays, in the
stacked `nn.scan` layout (for `swinunetr_icl` pass `params["backbone"]`).
Output: a state_dict of CPU tensors that `SwinUNETR.load_state_dict(...,
strict=True)` takes. A copy of `export_swinunetr` and
`swinunetr_conv_key_table` of `icl_tpu/utils/torch_import.py`, with the
layout transforms it needs:

    Conv:   flax (*k, I, O) -> torch (O, I, *k)
    ConvT:  flax (*k, I, O) -> torch (I, O, *k), spatially flipped
    Dense:  flax (I, O)     -> torch (O, I)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def f2t_conv(w: np.ndarray) -> np.ndarray:
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def f2t_convT(w: np.ndarray) -> np.ndarray:
    nd = w.ndim
    w = np.transpose(w, (nd - 2, nd - 1) + tuple(range(nd - 2)))
    return np.flip(w, axis=tuple(range(2, nd)))


def _res_block_table(t_prefix: str, f_path: tuple, wrapped: bool, has_conv3: bool):
    """UnetResBlock convs. UnetrBasicBlock wraps it as `.layer`; the up
    block's conv_block does not. Norms are affine-free, convs bias-free."""
    t = f"{t_prefix}.layer" if wrapped else t_prefix
    names = ("conv1", "conv2") + (("conv3",) if has_conv3 else ())
    return [(f"{t}.{c}.conv.weight", f_path + (c, "Conv_0", "kernel"), f2t_conv) for c in names]


def swinunetr_conv_key_table():
    """torch key -> (flax path, transform) for the UNETR conv half:
    5 encoders, 5 up blocks, the output conv."""
    table = []
    # conv3 exists iff the block changes the channel count
    for name, has3 in (("encoder1", True), ("encoder2", False), ("encoder3", False),
                       ("encoder4", False), ("encoder10", False)):
        table += _res_block_table(name, (name,), True, has3)
    for name in ("decoder5", "decoder4", "decoder3", "decoder2", "decoder1"):
        table.append((f"{name}.transp_conv.conv.weight",
                      (name, "transp_conv", "ConvTranspose_0", "kernel"), f2t_convT))
        table += _res_block_table(f"{name}.conv_block", (name, "conv_block"), False, True)
    table.append(("out.conv.conv.weight", ("out", "Conv_0", "kernel"), f2t_conv))
    table.append(("out.conv.conv.bias", ("out", "Conv_0", "bias"), None))
    return table


def swinunetr_state_dict_from_jax(params: dict, depths=(2, 2, 2, 2)) -> Dict[str, torch.Tensor]:
    """JAX SwinUNETR params (stacked scan layout) -> the port's state_dict."""
    out: Dict[str, np.ndarray] = {}
    for t_key, f_path, tf in swinunetr_conv_key_table():
        node = params
        for k in f_path:
            node = node[k]
        w = np.asarray(node)
        out[t_key] = w if tf is None else tf(w)

    sv = params["swinViT"]
    out["swinViT.patch_embed.proj.weight"] = f2t_conv(np.asarray(sv["patch_embed_proj"]["Conv_0"]["kernel"]))
    out["swinViT.patch_embed.proj.bias"] = np.asarray(sv["patch_embed_proj"]["Conv_0"]["bias"])

    def dense(node, t_key, b=None):
        k = np.asarray(node["Dense_0"]["kernel"])
        out[t_key + ".weight"] = (k if b is None else k[b]).T
        if "bias" in node["Dense_0"]:
            v = np.asarray(node["Dense_0"]["bias"])
            out[t_key + ".bias"] = v if b is None else v[b]

    def lnorm(node, t_key, b=None):
        s = np.asarray(node["LayerNorm_0"]["scale"])
        v = np.asarray(node["LayerNorm_0"]["bias"])
        out[t_key + ".weight"] = s if b is None else s[b]
        out[t_key + ".bias"] = v if b is None else v[b]

    for li, depth in enumerate(depths):
        layer = f"layers{li + 1}"
        blocks = sv[f"{layer}_blocks"]["blocks"]
        for b in range(depth):
            t = f"swinViT.{layer}.0.blocks.{b}"
            lnorm(blocks["norm1"], f"{t}.norm1", b)
            lnorm(blocks["norm2"], f"{t}.norm2", b)
            out[f"{t}.attn.relative_position_bias_table"] = np.asarray(
                blocks["attn"]["relative_position_bias_table"])[b]
            dense(blocks["attn"]["qkv"], f"{t}.attn.qkv", b)
            dense(blocks["attn"]["proj"], f"{t}.attn.proj", b)
            dense(blocks["mlp_linear1"], f"{t}.mlp.linear1", b)
            dense(blocks["mlp_linear2"], f"{t}.mlp.linear2", b)
        down = sv[f"{layer}_downsample"]
        dense(down["reduction"], f"swinViT.{layer}.0.downsample.reduction")
        lnorm(down["norm"], f"swinViT.{layer}.0.downsample.norm")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch state_dict file in the reference layout (`module.` prefixes
    and a `state_dict` wrapper are taken off)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}
