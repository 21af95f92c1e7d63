"""Carry SwinUNETR and SwinUNETR-ICL weights from the JAX package's
parameter tree to the port's state_dict (the reference key layout).

Input: the JAX params (and, for the ICL heads, batch_stats) as nested
dicts of numpy arrays; SwinUNETR in the stacked `nn.scan` layout.
Output: a state_dict of CPU tensors that the port's `load_state_dict(...,
strict=True)` takes. A copy of `export_swinunetr`,
`swinunetr_conv_key_table`, `icl_head_key_table` and `export_icl_heads` of
`icl_tpu/utils/torch_import.py`, with the layout transforms they need:

    Conv:   flax (*k, I, O) -> torch (O, I, *k)
    ConvT:  flax (*k, I, O) -> torch (I, O, *k), spatially flipped
    Dense:  flax (I, O)     -> torch (O, I)
    Dense as Conv1d k=1:      torch (O, I, 1)
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


def f2t_dense(w: np.ndarray) -> np.ndarray:
    return w.T


def f2t_dense_as_conv1d(w: np.ndarray) -> np.ndarray:
    return w.T[:, :, None]


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


BATCH_STATS = "__bs__"  # first element of a flax path that lives in batch_stats


def icl_head_key_table(torch_prefix: str = "", num_scales: int = 3):
    """torch key -> (flax path, transform) for one `InherentConsistent`
    head of SwinUNETR-ICL (its query spelled `guide_Q`), flax paths taken
    from the head's own subtree. BatchNorm running stats have paths that
    start with BATCH_STATS."""
    table = []
    p = torch_prefix

    def dense(t_key, f_path):
        table.append((f"{t_key}.weight", f_path + ("Dense_0", "kernel"), f2t_dense))
        table.append((f"{t_key}.bias", f_path + ("Dense_0", "bias"), None))

    def lnorm(t_key, f_path):
        table.append((f"{t_key}.weight", f_path + ("LayerNorm_0", "scale"), None))
        table.append((f"{t_key}.bias", f_path + ("LayerNorm_0", "bias"), None))

    def bnorm(t_key, f_path):
        table.append((f"{t_key}.weight", f_path + ("BatchNorm_0", "scale"), None))
        table.append((f"{t_key}.bias", f_path + ("BatchNorm_0", "bias"), None))
        table.append((f"{t_key}.running_mean", (BATCH_STATS,) + f_path + ("BatchNorm_0", "mean"), None))
        table.append((f"{t_key}.running_var", (BATCH_STATS,) + f_path + ("BatchNorm_0", "var"), None))

    table.append((f"{p}guide_Q", ("guided_Q",), None))
    for i in range(num_scales):
        table.append((f"{p}proj_layers.{i}.weight", (f"proj{i}", "Conv_0", "kernel"), f2t_conv))
        table.append((f"{p}proj_layers.{i}.bias", (f"proj{i}", "Conv_0", "bias"), None))
        lnorm(f"{p}norm_layers.{i}", (f"norm{i}",))
        cd_t, cd_f = f"{p}class_decoders.{i}", (f"class_decoder{i}",)
        for nm in ("norm1", "norm1_query", "norm2", "norm3"):
            lnorm(f"{cd_t}.{nm}", cd_f + (nm,))
        for nm in ("fc_q", "fc_kv", "proj"):
            dense(f"{cd_t}.attn.{nm}", cd_f + ("attn", nm))
        for mlp in ("mlp", "mlp2"):
            for fc in ("fc1", "fc2"):
                dense(f"{cd_t}.{mlp}.{fc}", cd_f + (mlp, fc))
        sc_t, sc_f = f"{p}attn_convs0.{i}.block", (f"attn_conv0_{i}",)
        table.append((f"{sc_t}.depthwise.weight", sc_f + ("depthwise", "Conv_0", "kernel"), f2t_conv))
        bnorm(f"{sc_t}.bn_depth", sc_f + ("bn_depth",))
        table.append((f"{sc_t}.pointwise.weight", sc_f + ("pointwise", "Conv_0", "kernel"), f2t_conv))
        bnorm(f"{sc_t}.bn_point", sc_f + ("bn_point",))
        table.append((f"{p}attn_convs1.{i}.weight", (f"attn_conv1_{i}", "Conv_0", "kernel"), f2t_conv))
        table.append((f"{p}attn_convs1.{i}.bias", (f"attn_conv1_{i}", "Conv_0", "bias"), None))
        table.append((f"{p}query_convs.{i}.weight", (f"query_conv{i}", "Dense_0", "kernel"),
                      f2t_dense_as_conv1d))
        table.append((f"{p}query_convs.{i}.bias", (f"query_conv{i}", "Dense_0", "bias"), None))
    return table


def icl_head_state_dict_from_jax(params: dict, batch_stats: dict,
                                 torch_prefix: str = "") -> Dict[str, torch.Tensor]:
    """One JAX `InherentConsistent` head's params and batch_stats -> the
    port's state_dict of it, keys prefixed with `torch_prefix`
    (`num_batches_tracked` 0: flax keeps no count)."""
    out: Dict[str, torch.Tensor] = {}
    for t_key, f_path, tf in icl_head_key_table(torch_prefix):
        node, path = (batch_stats, f_path[1:]) if f_path[0] == BATCH_STATS else (params, f_path)
        for k in path:
            node = node[k]
        w = np.asarray(node)
        out[t_key] = torch.from_numpy(np.array(w if tf is None else tf(w)))
        if t_key.endswith(".running_var"):
            out[t_key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def swinunetr_icl_state_dict_from_jax(params: dict, batch_stats: dict,
                                      depths=(2, 2, 2, 2)) -> Dict[str, torch.Tensor]:
    """JAX SwinUNETRICL params (backbone under "backbone", heads under
    "sspa" and "uscl") and batch_stats -> the port's full state_dict."""
    out = swinunetr_state_dict_from_jax(params["backbone"], depths)
    for name in ("sspa", "uscl"):
        out.update(icl_head_state_dict_from_jax(params[name], batch_stats[name], f"{name}."))
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch state_dict file in the reference layout (`module.` prefixes
    and a `state_dict` wrapper are taken off)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}
