"""2D per-volume inference, batched on the card (counterpart of
`icl_tpu/eval/infer2d.py`).

Every slice of a volume is zoomed to the patch on the host (order-0
scipy, as the reference); the slices go to the card in chunks of up to 32
and through one forward each, the argmax is taken there, and only the
label maps come back to be zoomed to the slice size. The metric protocol
(per class 1..C-1, binary dice and HD95 with the sentinels of
`metrics.py`) is the reference's. The JAX package pads each chunk to a
static 32 so that XLA compiles once; eager PyTorch needs no padding.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from scipy.ndimage import zoom as nd_zoom

from icl_tpu_torch.device import resolve_device
from icl_tpu_torch.metrics import aggregate_case_metrics, calculate_metric_percase


def make_slice_predictor(model: torch.nn.Module, patch_size, device=None,
                         chunk: int = 32) -> Callable[[np.ndarray], np.ndarray]:
    """predict(image [D, H, W]) -> uint8 labels [D, H, W]: the logits of
    `model` (called as model(x) on [n, 1, *patch_size] f32, without
    autograd) argmaxed over classes."""
    ph, pw = patch_size
    device = resolve_device(device)

    @torch.inference_mode()
    def predict(image: np.ndarray) -> np.ndarray:
        D, H, W = image.shape
        zoomed = np.stack([nd_zoom(image[d], (ph / H, pw / W), order=0) for d in range(D)])
        prediction = np.zeros(image.shape, dtype=np.uint8)
        for start in range(0, D, chunk):
            x = torch.from_numpy(zoomed[start:start + chunk].astype(np.float32)[:, None]).to(device)
            out = model(x).argmax(dim=1).to(torch.uint8).cpu().numpy()
            for d in range(out.shape[0]):
                prediction[start + d] = nd_zoom(out[d], (H / ph, W / pw), order=0)
        return prediction

    return predict


def generate_pseudo_labels(predict: Callable[[np.ndarray], np.ndarray], dataset,
                           root_path: str) -> int:
    """Per-slice pseudo-label files for a self-training round (counterpart
    of `generate_pseudo_labels`, icl_tpu/eval/infer2d.py:59-81; the
    reference's val_2D.py:89-109): `{root}/slices_iter1/{case}_slice_{d}.h5`
    (d from 1) holding the volume's original slice as "image" and
    `predict`'s label as "label", gzip-compressed. Returns the number of
    slices written."""
    import os

    import h5py  # only the writer needs it

    out_dir = os.path.join(root_path, "slices_iter1")
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i in range(len(dataset)):
        item = dataset[i]
        image = item["image"]
        prediction = predict(image)
        for d in range(image.shape[0]):
            with h5py.File(os.path.join(out_dir, f"{item['case']}_slice_{d + 1}.h5"), "w") as f:
                f.create_dataset("image", data=image[d], compression="gzip")
                f.create_dataset("label", data=prediction[d], compression="gzip")
            count += 1
    return count


def evaluate_acdc_volumes(predict: Callable[[np.ndarray], np.ndarray], dataset,
                          num_classes: int) -> dict:
    """The validation protocol over a volume dataset (items with "image"
    and "label" [D, H, W]): `aggregate_case_metrics` of the per-class
    dice and HD95 of each volume."""
    metric_cal = [[] for _ in range(num_classes - 1)]
    for i in range(len(dataset)):
        item = dataset[i]
        prediction = predict(item["image"])
        for cls in range(1, num_classes):
            metric_cal[cls - 1].append(calculate_metric_percase(prediction == cls, item["label"] == cls))
    return aggregate_case_metrics(metric_cal)
