"""Swin yaml config loader (counterpart of `icl_tpu/models/swin_config.py`):
the yaml's MODEL.SWIN / DATA / MODEL.DROP_PATH_RATE fields mapped onto
`SwinConfig`. Without a yaml the defaults are the swin-tiny-lite values.
`yaml` is imported only when a path is given."""
from __future__ import annotations

from typing import Optional

from icl_tpu_torch.models.swin2d import SwinConfig


def get_swin_config(yaml_path: Optional[str] = None, **overrides) -> SwinConfig:
    kwargs = {}
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            spec = yaml.safe_load(f) or {}
        model = spec.get("MODEL", {})
        swin = model.get("SWIN", {})
        mapping = {
            "img_size": spec.get("DATA", {}).get("IMG_SIZE"),
            "patch_size": swin.get("PATCH_SIZE"),
            "in_chans": swin.get("IN_CHANS"),
            "embed_dim": swin.get("EMBED_DIM"),
            "depths": tuple(swin["DEPTHS"]) if "DEPTHS" in swin else None,
            "num_heads": tuple(swin["NUM_HEADS"]) if "NUM_HEADS" in swin else None,
            "window_size": swin.get("WINDOW_SIZE"),
            "mlp_ratio": swin.get("MLP_RATIO"),
            "qkv_bias": swin.get("QKV_BIAS"),
            "drop_path_rate": model.get("DROP_PATH_RATE"),
            "ape": swin.get("APE"),
            "patch_norm": swin.get("PATCH_NORM"),
        }
        kwargs = {k: v for k, v in mapping.items() if v is not None}
    kwargs.update(overrides)
    return SwinConfig(**kwargs)


def swin_cli_kwargs(args) -> dict:
    """The `--cfg` flag of the Swin CLIs: the yaml -> model kwargs
    {"swin_cfg": SwinConfig}, with IMG_SIZE following --patch_size (the
    reference builds the net with the CLI's image size). No flag, no
    kwargs. Where `--pretrained_ckpt` is not given, the yaml's
    MODEL.PRETRAIN_CKPT takes its place if that file exists (the
    reference's `model.load_from(config)`, as the JAX CLIs do)."""
    if not getattr(args, "cfg", None):
        return {}
    import os

    import yaml

    kwargs = {"swin_cfg": get_swin_config(args.cfg, img_size=args.patch_size[0])}
    if not getattr(args, "pretrained_ckpt", None):
        with open(args.cfg) as f:
            ckpt = ((yaml.safe_load(f) or {}).get("MODEL") or {}).get("PRETRAIN_CKPT")
        if ckpt and os.path.exists(ckpt):
            args.pretrained_ckpt = ckpt
    return kwargs
