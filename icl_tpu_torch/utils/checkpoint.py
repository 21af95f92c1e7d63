"""The best-model checkpoint (counterpart of `save_best_model`,
`icl_tpu/utils/checkpoint.py:73-90`): the model's state_dict with the ICL
heads (`sspa.*`, `uscl.*`) stripped, as a torch file at
`<snapshot>/model/model_best.pth`, loadable with `strict=True` into the
inference graph (`SwinUNETR`)."""
from __future__ import annotations

import os

import torch

from icl_tpu_torch.models.swinunetr_icl import strip_icl_heads


def save_best_model(snapshot_path: str, model: torch.nn.Module) -> str:
    path = os.path.join(snapshot_path, "model", "model_best.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # strip before the copy to the host: the heads hold most of the bytes
    state = {k: v.detach().cpu() for k, v in strip_icl_heads(model.state_dict()).items()}
    torch.save(state, path)
    return path
