"""Carry SwinUNETR, SwinUNETR-ICL, Swin-UNet 2D, Swin-UNet-ICL, U-Net 2D,
U-Net-ICL 2D, U-Net 3D and U-Net-ICL 3D weights from the JAX package's
parameter tree to the port's state_dict (the reference key layout).

Input: the JAX params (and, for the ICL heads, batch_stats) as nested
dicts of numpy arrays; SwinUNETR in the stacked `nn.scan` layout.
Output: a state_dict of CPU tensors that the port's `load_state_dict(...,
strict=True)` takes. A copy of `export_swinunetr`,
`swinunetr_conv_key_table`, `swinunet2d_full_key_table`,
`export_swinunet2d`, `unet2d_key_table`, `export_icl_unet2d`,
`unet3d_key_table`, `export_icl_unet3d`, `icl_head_key_table` and
`export_icl_heads` of
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


def icl_head_key_table(torch_prefix: str = "", num_scales: int = 3, tokenized: bool = False,
                       query_name: str = "guide_Q"):
    """torch key -> (flax path, transform) for one `InherentConsistent`
    head, flax paths taken from the head's own subtree: SwinUNETR-ICL's
    (query `guide_Q`), or with `tokenized` and `query_name="guided_Q"`
    Swin-UNet-ICL's, which has no proj conv or norm. BatchNorm running
    stats have paths that start with BATCH_STATS."""
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

    table.append((f"{p}{query_name}", ("guided_Q",), None))
    for i in range(num_scales):
        if not tokenized:
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


def _state_dict_from_table(table, params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Apply a (torch key, flax path, transform) table to a params tree and
    a batch_stats tree (`num_batches_tracked` 0: flax keeps no count)."""
    out: Dict[str, torch.Tensor] = {}
    for t_key, f_path, tf in table:
        node, path = (batch_stats, f_path[1:]) if f_path[0] == BATCH_STATS else (params, f_path)
        for k in path:
            node = node[k]
        w = np.asarray(node)
        out[t_key] = torch.from_numpy(np.array(w if tf is None else tf(w)))
        if t_key.endswith(".running_var"):
            out[t_key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def icl_head_state_dict_from_jax(params: dict, batch_stats: dict, torch_prefix: str = "",
                                 tokenized: bool = False,
                                 query_name: str = "guide_Q") -> Dict[str, torch.Tensor]:
    """One JAX `InherentConsistent` head's params and batch_stats -> the
    port's state_dict of it, keys prefixed with `torch_prefix`."""
    table = icl_head_key_table(torch_prefix, tokenized=tokenized, query_name=query_name)
    return _state_dict_from_table(table, params, batch_stats)


def swinunetr_icl_state_dict_from_jax(params: dict, batch_stats: dict,
                                      depths=(2, 2, 2, 2)) -> Dict[str, torch.Tensor]:
    """JAX SwinUNETRICL params (backbone under "backbone", heads under
    "sspa" and "uscl") and batch_stats -> the port's full state_dict."""
    out = swinunetr_state_dict_from_jax(params["backbone"], depths)
    for name in ("sspa", "uscl"):
        out.update(icl_head_state_dict_from_jax(params[name], batch_stats[name], f"{name}."))
    return out


def _swin_block_entries(t: str, f: str):
    """One 2D Swin block: norms, rel-pos table, qkv / proj, mlp."""
    table = [(f"{t}.attn.relative_position_bias_table", (f, "attn", "relative_position_bias_table"),
              None)]
    for nm in ("norm1", "norm2"):
        table += [(f"{t}.{nm}.weight", (f, nm, "LayerNorm_0", "scale"), None),
                  (f"{t}.{nm}.bias", (f, nm, "LayerNorm_0", "bias"), None)]
    for t_key, f_path in (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                          ("mlp.fc1", ("mlp", "fc1")), ("mlp.fc2", ("mlp", "fc2"))):
        table += [(f"{t}.{t_key}.weight", (f,) + f_path + ("Dense_0", "kernel"), f2t_dense),
                  (f"{t}.{t_key}.bias", (f,) + f_path + ("Dense_0", "bias"), None)]
    return table


def swinunet2d_full_key_table(depths=(2, 2, 2, 2)):
    """torch key -> (flax path, transform) for the whole SwinTransformerSys:
    patch embed, encoder blocks and downsamples, bottleneck norm, decoder
    (PatchExpand, concat_back_dim, blocks, upsamples), FinalPatchExpand_X4
    and the output conv."""
    table = []

    def lnorm(t, f):
        table.extend([(f"{t}.weight", f + ("LayerNorm_0", "scale"), None),
                      (f"{t}.bias", f + ("LayerNorm_0", "bias"), None)])

    def dense(t, f, bias=True):
        table.append((f"{t}.weight", f + ("Dense_0", "kernel"), f2t_dense))
        if bias:
            table.append((f"{t}.bias", f + ("Dense_0", "bias"), None))

    table.append(("patch_embed.proj.weight", ("patch_embed_proj", "Conv_0", "kernel"), f2t_conv))
    table.append(("patch_embed.proj.bias", ("patch_embed_proj", "Conv_0", "bias"), None))
    lnorm("patch_embed.norm", ("patch_embed_norm",))
    n = len(depths)
    for i in range(n):
        for b in range(depths[i]):
            table += _swin_block_entries(f"layers.{i}.blocks.{b}", f"layers{i}_block{b}")
        if i < n - 1:
            dense(f"layers.{i}.downsample.reduction", (f"layers{i}_downsample", "reduction"),
                  bias=False)
            lnorm(f"layers.{i}.downsample.norm", (f"layers{i}_downsample", "norm"))
    lnorm("norm", ("norm",))
    dense("layers_up.0.expand", ("layers_up0_expand", "expand"), bias=False)
    lnorm("layers_up.0.norm", ("layers_up0_expand", "norm"))
    for i in range(1, n):
        dense(f"concat_back_dim.{i}", (f"concat_back_dim{i}",))
        for b in range(depths[n - 1 - i]):
            table += _swin_block_entries(f"layers_up.{i}.blocks.{b}", f"layers_up{i}_block{b}")
        if i < n - 1:
            dense(f"layers_up.{i}.upsample.expand", (f"layers_up{i}_expand", "expand"), bias=False)
            lnorm(f"layers_up.{i}.upsample.norm", (f"layers_up{i}_expand", "norm"))
    lnorm("norm_up", ("norm_up",))
    dense("up.expand", ("up_x4", "expand"), bias=False)
    lnorm("up.norm", ("up_x4", "norm"))
    table.append(("output.weight", ("output", "Conv_0", "kernel"), f2t_conv))
    return table


def swinunet2d_state_dict_from_jax(params: dict, img_size: int = 224, window: int = 7,
                                   depths=(2, 2, 2, 2), torch_prefix: str = "",
                                   patch_size: int = 4) -> Dict[str, torch.Tensor]:
    """JAX SwinUNet2D params -> the port's state_dict, with the buffers
    `export_swinunet2d` writes (each block's relative-position index and
    each shifted block's mask) made anew from the geometry."""
    from icl_tpu_torch.models.swin2d import relative_position_index_2d, shifted_window_mask

    sd = _state_dict_from_table(swinunet2d_full_key_table(depths), params, {})
    n, pr = len(depths), img_size // patch_size

    def buffers(t, res, b):
        ws = min(window, res)
        sd[f"{t}.attn.relative_position_index"] = torch.from_numpy(relative_position_index_2d(ws))
        if b % 2 == 1 and res > window:
            sd[f"{t}.attn_mask"] = torch.from_numpy(shifted_window_mask(res, res, ws, window // 2))

    for i in range(n):
        for b in range(depths[i]):
            buffers(f"layers.{i}.blocks.{b}", pr // 2**i, b)
    for i in range(1, n):
        for b in range(depths[n - 1 - i]):
            buffers(f"layers_up.{i}.blocks.{b}", pr // 2 ** (n - 1 - i), b)
    return {torch_prefix + k: v for k, v in sd.items()}


def icl_swinunet2d_state_dict_from_jax(params: dict, batch_stats: dict, img_size: int = 224,
                                       window: int = 7,
                                       depths=(2, 2, 2, 2)) -> Dict[str, torch.Tensor]:
    """JAX SwinUNetICL params (backbone under "swin_unet", tokenized heads
    under "sspa" and "uscl") and batch_stats -> the port's full state_dict."""
    out = swinunet2d_state_dict_from_jax(params["swin_unet"], img_size, window, depths,
                                         torch_prefix="swin_unet.")
    for name in ("sspa", "uscl"):
        out.update(icl_head_state_dict_from_jax(params[name], batch_stats[name], f"{name}.",
                                                tokenized=True, query_name="guided_Q"))
    return out


def _convblock_entries(torch_prefix: str, flax_path: tuple):
    """ConvBlock: torch Sequential indices 0 conv, 1 BN, 4 conv, 5 BN."""
    out = []
    for t_idx, name in ((0, "conv1"), (4, "conv2")):
        out.append((f"{torch_prefix}.conv_conv.{t_idx}.weight",
                    flax_path + (name, "Conv_0", "kernel"), f2t_conv))
        out.append((f"{torch_prefix}.conv_conv.{t_idx}.bias", flax_path + (name, "Conv_0", "bias"),
                    None))
    for t_idx, name in ((1, "bn1"), (5, "bn2")):
        base, f = f"{torch_prefix}.conv_conv.{t_idx}", flax_path + (name, "BatchNorm_0")
        out.append((f"{base}.weight", f + ("scale",), None))
        out.append((f"{base}.bias", f + ("bias",), None))
        out.append((f"{base}.running_mean", (BATCH_STATS,) + f + ("mean",), None))
        out.append((f"{base}.running_var", (BATCH_STATS,) + f + ("var",), None))
    return out


def unet2d_key_table():
    """torch key -> (flax path, transform) for the reference 2D U-Net:
    encoder ConvBlocks, decoder UpBlocks (conv1x1 + ConvBlock; the
    upsample has no parameters) and the output conv."""
    table = _convblock_entries("encoder.in_conv", ("encoder", "in_conv"))
    for i in range(1, 5):
        table += _convblock_entries(f"encoder.down{i}.maxpool_conv.1", ("encoder", f"down{i}"))
    for i in range(1, 5):
        base, f = f"decoder.up{i}", ("decoder", f"up{i}")
        table.append((f"{base}.conv1x1.weight", f + ("conv1x1", "Conv_0", "kernel"), f2t_conv))
        table.append((f"{base}.conv1x1.bias", f + ("conv1x1", "Conv_0", "bias"), None))
        table += _convblock_entries(f"{base}.conv", f + ("conv",))
    table.append(("decoder.out_conv.weight", ("decoder", "out_conv", "Conv_0", "kernel"), f2t_conv))
    table.append(("decoder.out_conv.bias", ("decoder", "out_conv", "Conv_0", "bias"), None))
    return table


def unet2d_state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """JAX UNet (or UNetICL backbone) params and batch_stats -> the port's
    `UNet` state_dict."""
    return _state_dict_from_table(unet2d_key_table(), params, batch_stats)


def icl_unet2d_state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """JAX UNetICL params (backbone under "encoder" and "decoder", heads
    under "sspa" and "uscl") and batch_stats -> the port's full state_dict."""
    out = unet2d_state_dict_from_jax(params, batch_stats)
    for name in ("sspa", "uscl"):
        out.update(icl_head_state_dict_from_jax(params[name], batch_stats[name], f"{name}.",
                                                query_name="guided_Q"))
    return out


def unet3d_key_table():
    """torch key -> (flax path, transform) for the reference 3D U-Net:
    each UnetConv3's two convs (`conv{1,2}.0`; its InstanceNorms have no
    parameters), the up stages' blocks and the output conv."""
    table = []
    blocks = [(name, (name,)) for name in ("conv1", "conv2", "conv3", "conv4", "center")]
    blocks += [(f"up_concat{i}.conv", (f"up_concat{i}", "conv")) for i in (4, 3, 2, 1)]
    for t, f in blocks:
        for conv in ("conv1", "conv2"):
            table.append((f"{t}.{conv}.0.weight", f + (conv, "kernel"), f2t_conv))
            table.append((f"{t}.{conv}.0.bias", f + (conv, "bias"), None))
    table.append(("final.weight", ("final", "kernel"), f2t_conv))
    table.append(("final.bias", ("final", "bias"), None))
    return table


def unet3d_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX UNet3D params (or UNet3DICL's "backbone" subtree) -> the port's
    `UNet3D` state_dict."""
    return _state_dict_from_table(unet3d_key_table(), params, {})


def icl_unet3d_state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """JAX UNet3DICL params (backbone under "backbone", heads under "sspa"
    and "uscl") and batch_stats -> the port's full state_dict, the
    backbone's keys at its root."""
    out = unet3d_state_dict_from_jax(params["backbone"])
    for name in ("sspa", "uscl"):
        out.update(icl_head_state_dict_from_jax(params[name], batch_stats[name], f"{name}.",
                                                query_name="guided_Q"))
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A torch state_dict file in the reference layout (`module.` prefixes
    and a `state_dict` wrapper are taken off)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}
