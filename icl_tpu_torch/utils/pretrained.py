"""Pretrained initialisations (the port's own copy of the key surgery of
`icl_tpu/utils/torch_import.py:396-420, 514-528, 710-762`).

  * `load_pretrained_swinunet`: an ImageNet Swin-T state_dict into a
    Swin-UNet (`SwinUnetWrapper`, `SwinUNetICL`): the encoder's
    `layers.{i}` mirrored into the decoder's `layers_up.{3-i}` and the
    classification head dropped (the reference's vision_transformer.py
    load_from);
  * `load_pretrained_swinvit`: a self-supervised SwinViT state_dict
    (MONAI's `model_swinvit.pt` layout: `module.` prefixes, the encoder
    under `swin_vit.` or at the root, the MLP as `fc1/fc2` or
    `linear1/linear2`) into a SwinUNETR (`SwinUNETR`, `SwinUNETRICL`)
    under `swinViT.`.

The port's modules carry the reference key layout, so a load is key
surgery and `load_state_dict(strict=False)` of the kept keys: those of
the model's parameters whose shape matches. Every other key is dropped
and printed with its reason, as the reference prints its deletions and
the JAX loaders' `prune_mismatched` and `_report_dropped` log theirs;
nothing is transposed.
"""
from __future__ import annotations

from typing import Dict

import torch

from icl_tpu_torch.utils.convert import load_state_dict_file


def imagenet_swin_remap(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ImageNet Swin surgery (vision_transformer.py:111-146): the
    classification head's keys dropped, each encoder key `layers.{i}...`
    also placed at the decoder's `layers_up.{3-i}...`."""
    sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
    full = dict(sd)
    for k, v in sd.items():
        if k.startswith("layers."):
            full[f"layers_up.{3 - int(k[7:8])}{k[8:]}"] = v
    return full


def ssl_swinvit_fixup(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The SSL SwinViT surgery (train_..._swinunetr_3D_BraTS.py:77-99):
    `module.` and the `swin_vit.` / `swinViT.` encoder prefix taken off,
    the MLP's `fc1/fc2` spelled `linear1/linear2` as the model names them
    (the JAX package spells both `fc`, its converter's names)."""
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "swin_vit.", "swinViT."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k.replace(".mlp.fc1.", ".mlp.linear1.").replace(".mlp.fc2.", ".mlp.linear2.")] = v
    return out


def load_partial(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                 what: str) -> tuple[list[str], list[tuple[str, str]]]:
    """Load the keys of `sd` that name a parameter of `model` of the same
    shape; drop the others, each printed with its reason. Returns (kept
    keys, [(dropped key, reason)])."""
    params = dict(model.named_parameters())
    kept, dropped = [], []
    for k, v in sd.items():
        if k not in params:
            dropped.append((k, "no such parameter"))
        elif tuple(v.shape) != tuple(params[k].shape):
            dropped.append((k, f"shape {tuple(v.shape)} vs model {tuple(params[k].shape)}"))
        else:
            kept.append(k)
    model.load_state_dict({k: sd[k] for k in kept}, strict=False)
    report_dropped(dropped, what)
    print(f"pretrained {what}: {len(kept)} keys loaded, {len(dropped)} dropped")
    return kept, dropped


def report_dropped(dropped, what: str) -> None:
    for key, reason in dropped:
        print(f"delete key {key} from pretrained {what}: {reason}")


def load_pretrained_swinunet(model: torch.nn.Module,
                             path: str) -> tuple[list[str], list[tuple[str, str]]]:
    """An ImageNet Swin-T checkpoint into the `swin_unet` of a Swin-UNet
    (counterpart of `load_pretrained_swinunet`, torch_import.py:745-762).
    Returns `load_partial`'s (kept, dropped); the head's keys are among
    the dropped."""
    sd = load_state_dict_file(path)
    heads = [(k, "ImageNet classification head") for k in sd if k.startswith("head.")]
    sd = {f"swin_unet.{k}": v for k, v in imagenet_swin_remap(sd).items()}
    report_dropped(heads, "ImageNet Swin checkpoint")
    kept, dropped = load_partial(model, sd, "ImageNet Swin checkpoint")
    return kept, heads + dropped


def load_pretrained_swinvit(model: torch.nn.Module,
                            path: str) -> tuple[list[str], list[tuple[str, str]]]:
    """A self-supervised SwinViT checkpoint into the `swinViT` of a
    SwinUNETR (counterpart of `load_pretrained_swinvit`,
    torch_import.py:514-528). Returns `load_partial`'s (kept, dropped)."""
    sd = {f"swinViT.{k}": v for k, v in ssl_swinvit_fixup(load_state_dict_file(path)).items()}
    return load_partial(model, sd, "SSL SwinViT checkpoint")
