"""3D sliding-window inference with overlap stitching (counterpart of
`icl_tpu/eval/infer3d.py`, BraTS and AMOS protocols).

Reference protocol (val_3D.py:15-82): pad the volume to at least the
patch, lay out start positions xs = min(stride*i, dim - patch), score
each patch (softmax for BraTS, raw logits for AMOS), mean-stitch through
score and count maps, argmax, unpad. The volume is uploaded once; patches
are cut, forwarded sw_batch at a time, and stitched on the device; only
the label map comes back.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.metrics import calculate_metric_percase


def _grid_starts(dim: int, patch: int, stride: int) -> list[int]:
    n = math.ceil((dim - patch) / stride) + 1
    return [min(stride * i, dim - patch) for i in range(n)]


def make_patch_predictor(model: torch.nn.Module, apply_softmax: bool = True,
                         dtype: torch.dtype | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(patches [n, in_chns, *patch]) -> per-patch scores [n, classes,
    *patch] in f32, computed without autograd: softmax probabilities (the
    BraTS protocol) or, with `apply_softmax=False`, the raw logits (the
    AMOS protocol). `dtype` rounds the input to that type and back to f32
    and nothing else: the JAX package casts the input alone, and its f32
    conv kernels promote the rounded input back to f32 (infer3d.py:29-51),
    so the network runs in f32 either way."""

    @torch.inference_mode()
    def _scores(x: torch.Tensor) -> torch.Tensor:
        if dtype is not None:
            x = x.to(dtype).float()
        logits = model(x).float()
        return torch.softmax(logits, dim=1) if apply_softmax else logits

    return _scores


def sliding_window_predict(
    probs_fn: Callable[[torch.Tensor], torch.Tensor],
    image: np.ndarray,
    num_classes: int,
    patch_size: Sequence[int] = (96, 96, 96),
    stride_xy: int = 64,
    stride_z: int = 64,
    sw_batch: int = 4,
    device=None,
) -> np.ndarray:
    """Label map [W, H, D] (uint8) for one volume, reference semantics."""
    device = resolve_device(device)
    w, h, d = image.shape
    pw, ph, pd = patch_size
    wp, hp, dp = max(pw - w, 0), max(ph - h, 0), max(pd - d, 0)
    pads = ((wp // 2, wp - wp // 2), (hp // 2, hp - hp // 2), (dp // 2, dp - dp // 2))
    padded = np.pad(image, pads, mode="constant", constant_values=0) if (wp or hp or dp) else image
    ww, hh, dd = padded.shape
    volume = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32)).to(device)

    starts = [(xs, ys, zs)
              for xs in _grid_starts(ww, pw, stride_xy)
              for ys in _grid_starts(hh, ph, stride_xy)
              for zs in _grid_starts(dd, pd, stride_z)]
    score = torch.zeros((num_classes, ww, hh, dd), dtype=torch.float32, device=device)
    cnt = torch.zeros((ww, hh, dd), dtype=torch.float32, device=device)
    for c0 in range(0, len(starts), sw_batch):
        chunk = starts[c0:c0 + sw_batch]
        patches = torch.stack([volume[xs:xs + pw, ys:ys + ph, zs:zs + pd] for xs, ys, zs in chunk])
        probs = probs_fn(patches[:, None])
        for (xs, ys, zs), p in zip(chunk, probs):
            score[:, xs:xs + pw, ys:ys + ph, zs:zs + pd] += p
            cnt[xs:xs + pw, ys:ys + ph, zs:zs + pd] += 1.0
    label_map = torch.argmax(score / cnt, dim=0).to(torch.uint8).cpu().numpy()
    if wp or hp or dp:
        label_map = label_map[pads[0][0]:pads[0][0] + w, pads[1][0]:pads[1][0] + h,
                              pads[2][0]:pads[2][0] + d]
    return label_map


def make_fused_sliding_window(model: torch.nn.Module, num_classes: int,
                              patch_size: Sequence[int] = (96, 96, 96), sw_batch: int = 4,
                              apply_softmax: bool = True, dtype: torch.dtype | None = None,
                              device=None) -> Callable[..., np.ndarray]:
    """predict(image [W, H, D], stride_xy=64, stride_z=64) -> label map, as
    `sliding_window_predict` with `make_patch_predictor(model,
    apply_softmax, dtype)` computes it (softmax stitched for BraTS, logits
    for AMOS), with the patches gathered by one index per chunk and
    stitched by `index_add_` into flat score and count volumes
    (counterpart of `make_fused_sliding_window`, icl_tpu/eval/infer3d.py:114;
    its mesh option is not ported). On the CPU the stitch adds in the same
    order as `sliding_window_predict`, so the label maps are equal; on the
    card `index_add_` may add overlapping patches in another order."""
    scores_fn = make_patch_predictor(model, apply_softmax, dtype)
    device = resolve_device(device)
    pw, ph, pd = patch_size

    @torch.inference_mode()
    def predict(image: np.ndarray, stride_xy: int = 64, stride_z: int = 64) -> np.ndarray:
        w, h, d = image.shape
        wp, hp, dp = max(pw - w, 0), max(ph - h, 0), max(pd - d, 0)
        pads = ((wp // 2, wp - wp // 2), (hp // 2, hp - hp // 2), (dp // 2, dp - dp // 2))
        padded = np.pad(image, pads, mode="constant") if (wp or hp or dp) else image
        ww, hh, dd = padded.shape
        volume = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float32)).to(device).view(-1)
        starts = torch.tensor([(xs, ys, zs) for xs in _grid_starts(ww, pw, stride_xy)
                               for ys in _grid_starts(hh, ph, stride_xy)
                               for zs in _grid_starts(dd, pd, stride_z)], device=device)
        ox, oy, oz = (torch.arange(n, device=device) for n in (pw, ph, pd))
        local = (ox[:, None, None] * hh + oy[None, :, None]) * dd + oz[None, None, :]
        flat = (starts[:, 0] * hh + starts[:, 1]) * dd + starts[:, 2]
        index = flat[:, None, None, None] + local  # [patches, pw, ph, pd] into the flat volume
        score = torch.zeros((num_classes, volume.numel()), dtype=torch.float32, device=device)
        cnt = torch.zeros(volume.numel(), dtype=torch.float32, device=device)
        for c0 in range(0, index.shape[0], sw_batch):
            idx = index[c0:c0 + sw_batch]
            scores = scores_fn(volume[idx][:, None])  # [n, classes, pw, ph, pd]
            score.index_add_(1, idx.reshape(-1), scores.transpose(0, 1).reshape(num_classes, -1))
            cnt.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), device=device))
        label_map = torch.argmax(score / cnt, dim=0).to(torch.uint8).view(ww, hh, dd).cpu().numpy()
        if wp or hp or dp:
            label_map = label_map[pads[0][0]:pads[0][0] + w, pads[1][0]:pads[1][0] + h,
                                  pads[2][0]:pads[2][0] + d]
        return label_map

    return predict


def evaluate_amos_cases(scores_fn, dataset, num_classes: int = 16, roi=(96, 96, 96),
                        sw_batch: int = 4, device=None):
    """test_all_case_amos protocol (val_3D.py:120-138): the sliding window
    of MONAI's sliding_window_inference at overlap 0.25 (stride int(0.75 *
    roi), 72 at 96^3) over logits, argmax, per organ (dice, hd95); returns
    metric_cal[organ][case]."""
    stride = int(roi[0] * 0.75)
    return evaluate_brats_cases(scores_fn, dataset, num_classes, roi, stride, stride, sw_batch,
                                device)


def evaluate_brats_cases(
    probs_fn,
    dataset,
    num_classes: int,
    patch_size=(96, 96, 96),
    stride_xy: int = 64,
    stride_z: int = 64,
    sw_batch: int = 4,
    device=None,
):
    """test_all_case_base protocol (val_3D.py:100-118): per case and per
    foreground class (dice, hd95); returns metric_cal[class][case]."""
    metric_cal = [[] for _ in range(num_classes - 1)]
    for i in range(len(dataset)):
        item = dataset[i]
        prediction = sliding_window_predict(probs_fn, item["image"], num_classes, patch_size,
                                            stride_xy, stride_z, sw_batch, device)
        for cls in range(1, num_classes):
            metric_cal[cls - 1].append(calculate_metric_percase(prediction == cls, item["label"] == cls))
    return metric_cal
