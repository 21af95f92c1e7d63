"""AMOS22: the Decathlon JSON datalist and the MONAI-equivalent transforms
(counterpart of `icl_tpu/data/amos.py`), channel-first batches.

The reference composes (train_inherent_consistent_unet_3D_AMOS22.py:84-159):

  deterministic (computed once per case and cached, as CacheDataset does):
    LoadImaged -> ScaleIntensityRanged(-175, 250 -> 0, 1, clip) ->
    CropForegroundd(source='image') -> Orientationd(RAS) ->
    Spacingd((1.5, 1.5, 2.0), bilinear / nearest)
  random (per access):
    RandSpatialCropd(96^3) -> SpatialPadd(96^3) -> RandFlipd x3 (p .1) ->
    RandRotate90d(p .1, max_k 3) -> RandShiftIntensityd(.1, p .5)

Spacingd is `resample.monai_spacing_resample` (the JAX package's
`exact=True` path, the one its datasets take; its scipy-zoom comparison
path is not copied). The random draws come from a numpy generator in the
JAX package's order, so one seed gives the same batches in both packages.

Organ tags of classes 1..15: SPL RKI LKI GBL ESO LIV STO AOR IVC PAN RAG
LAG DUO BLA PRO/UTE (AMOS22 script :159).
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from icl_tpu_torch.data.manifests import VENDORED_ROOT
from icl_tpu_torch.data.nifti import load_nifti, to_ras
from icl_tpu_torch.data.resample import monai_spacing_resample
from icl_tpu_torch.data.sampler import two_stream_batches

AMOS_CLASS_NAMES = [
    "SPL", "RKI", "LKI", "GBL", "ESO", "LIV", "STO", "AOR", "IVC", "PAN",
    "RAG", "LAG", "DUO", "BLA", "PRO/UTE",
]


def load_decathlon_datalist(json_path: str, section: str = "training") -> list[dict]:
    """MONAI's load_decathlon_datalist: the entries of `section`, their
    relative paths resolved against the JSON's directory. A JSON missing
    from there is read from the repo's vendored official split
    (`data/AMOS22/`), its paths still resolved against the directory the
    caller named, where the volumes are."""
    base = os.path.dirname(os.path.abspath(json_path))
    if not os.path.exists(json_path):
        vendored = os.path.join(VENDORED_ROOT, "AMOS22", os.path.basename(json_path))
        if os.path.exists(vendored):
            json_path = vendored
    with open(json_path) as f:
        spec = json.load(f)
    items = []
    for entry in spec[section]:
        if isinstance(entry, str):
            entry = {"image": entry}
        items.append({k: os.path.join(base, v) if isinstance(v, str) else v
                      for k, v in entry.items()})
    return items


def scale_intensity_range(img, a_min=-175.0, a_max=250.0, b_min=0.0, b_max=1.0):
    img = (img.astype(np.float32) - a_min) / (a_max - a_min)
    img = img * (b_max - b_min) + b_min
    return np.clip(img, b_min, b_max)


def crop_foreground(image, label, select=lambda x: x > 0, margin: int = 0):
    """The bounding box of select(image), applied to both (MONAI
    CropForegroundd's defaults)."""
    mask = select(image)
    if not mask.any():
        return image, label
    sl = []
    for ax in range(3):
        other = tuple(i for i in range(3) if i != ax)
        idx = np.where(mask.any(axis=other))[0]
        sl.append(slice(max(0, idx[0] - margin), min(image.shape[ax], idx[-1] + 1 + margin)))
    sl = tuple(sl)
    return image[sl], label[sl]


def resample_spacing(image, label, affine, new_spacing=(1.5, 1.5, 2.0)):
    """Spacingd: bilinear for the image, nearest for the label."""
    image, _ = monai_spacing_resample(image, affine, new_spacing, mode="bilinear")
    label, _ = monai_spacing_resample(label, affine, new_spacing, mode="nearest")
    return image, label


def spatial_pad(image, label, size=(96, 96, 96)):
    """Centred symmetric pad to at least `size` (MONAI SpatialPadd)."""
    pads = []
    for ax in range(3):
        need = max(size[ax] - image.shape[ax], 0)
        pads.append((need // 2, need - need // 2))
    if any(p != (0, 0) for p in pads):
        image = np.pad(image, pads, mode="constant")
        label = np.pad(label, pads, mode="constant")
    return image, label


def rand_spatial_crop(image, label, size, rng: np.random.Generator):
    starts = []
    for ax in range(3):
        span = image.shape[ax] - size[ax]
        starts.append(int(rng.integers(0, span + 1)) if span > 0 else 0)
    sl = tuple(slice(s, s + size[ax]) for ax, s in enumerate(starts))
    return image[sl], label[sl]


class AMOSDataset:
    """The deterministic preprocessing computed once per case and kept in
    memory with `cache` (CacheDataset); the random augmentations per
    access through `augment` (AMOS22 script :180-186). `val_mode` pads to
    96^3 before the spacing, the reference's validation order (:139-158)."""

    def __init__(self, datalist: list[dict], cache: bool = True, spacing=(1.5, 1.5, 2.0),
                 val_mode: bool = False):
        self.datalist = datalist
        self.spacing = spacing
        self.val_mode = val_mode
        self._cache: dict[int, tuple] | None = {} if cache else None

    def __len__(self):
        return len(self.datalist)

    def _load(self, idx: int):
        item = self.datalist[idx]
        img_vol = load_nifti(item["image"])
        lab_vol = load_nifti(item["label"])
        image, affine = to_ras(img_vol.data, img_vol.affine)
        label, _ = to_ras(lab_vol.data, lab_vol.affine)
        image = scale_intensity_range(image)
        image, label = crop_foreground(image, label)
        if self.val_mode:
            image, label = spatial_pad(image, label)
        image, label = resample_spacing(image, label, affine, self.spacing)
        return image.astype(np.float32), label.astype(np.uint8)

    def preprocessed(self, idx: int):
        if self._cache is None:
            return self._load(idx)
        if idx not in self._cache:
            self._cache[idx] = self._load(idx)
        return self._cache[idx]

    def augment(self, idx: int, rng: np.random.Generator, roi=(96, 96, 96)):
        """One random crop of case `idx` with its flips, rotation and
        intensity shift, drawn from `rng` in the reference's order."""
        image, label = self.preprocessed(idx)
        image, label = rand_spatial_crop(image, label, roi, rng)
        image, label = spatial_pad(image, label, roi)
        for ax in range(3):
            if rng.random() < 0.10:
                image = np.flip(image, axis=ax)
                label = np.flip(label, axis=ax)
        if rng.random() < 0.10:
            k = int(rng.integers(1, 4))
            image = np.rot90(image, k, axes=(0, 1))
            label = np.rot90(label, k, axes=(0, 1))
        if rng.random() < 0.50:
            image = image + rng.uniform(-0.10, 0.10)
        return np.ascontiguousarray(image), np.ascontiguousarray(label)

    def __getitem__(self, idx: int) -> dict:
        image, label = self.preprocessed(idx)
        return {"image": image, "label": label, "idx": idx}


def _augmented_batch(dataset: AMOSDataset, idxs, roi, aug_rng: np.random.Generator) -> dict:
    imgs, labs = [], []
    for i in idxs:
        img, lab = dataset.augment(int(i), aug_rng, roi)
        imgs.append(img.astype(np.float32)[None])
        labs.append(lab.astype(np.uint8))
    return {"image": np.stack(imgs), "label": np.stack(labs)}


def amos_train_batches(dataset: AMOSDataset, labeled_count: int, total_count: int,
                       batch_size: int, labeled_bs: int, roi=(96, 96, 96),
                       seed: int = 1337) -> Iterator[dict]:
    """Endless [labeled..., unlabeled...] batches: "image" [B, 1, *roi] f32
    and "label" [B, *roi] uint8; cases below `labeled_count` are the
    labeled ones, the rest up to `total_count` the unlabeled ones."""
    aug_rng = np.random.default_rng(seed + 1)
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, total_count)),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        yield _augmented_batch(dataset, idxs, roi, aug_rng)


def amos_supervised_batches(dataset: AMOSDataset, count: int, batch_size: int,
                            roi=(96, 96, 96), seed: int = 1337) -> Iterator[dict]:
    """Endless labeled batches over cases [0, count): one fresh
    permutation per epoch (from `seed`; the remainder dropped), augmented
    from `seed + 1` (train_fully_supervised_unet_3D_AMOS22.py:159).
    Raises if `count` cannot fill one batch (the JAX package's loop then
    spins without yielding)."""
    if count < batch_size:
        raise ValueError(f"{count} cases cannot fill a batch of {batch_size}")
    rng = np.random.default_rng(seed)
    aug_rng = np.random.default_rng(seed + 1)
    while True:
        perm = rng.permutation(count)
        for start in range(0, count - batch_size + 1, batch_size):
            yield _augmented_batch(dataset, perm[start:start + batch_size], roi, aug_rng)
