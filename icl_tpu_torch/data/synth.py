"""Seeded synthetic data: BraTS cases and ACDC slices and volumes in memory
(the arrays of `icl_tpu/data/synth.py`'s `make_synthetic_brats` and
`make_synthetic_acdc`, drawn in the same order, without the h5 files), and
an AMOS22 Decathlon tree of NIfTI files (`make_synthetic_amos`, the same
files as the JAX package's)."""
from __future__ import annotations

import json
import os

import numpy as np

from icl_tpu_torch.data.nifti import save_nifti


def synthetic_brats_cases(num_cases: int, size: int, seed: int = 0) -> list[dict]:
    """`num_cases` dicts {"image" [size]^3 f32, "label" [size]^3 uint8,
    "case"}: noise N(0, 0.1^2) with a spherical whole tumour of intensity
    +1, label 1 inside it. The same seed gives the same volumes as the h5
    fixture."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.ogrid[0:size, 0:size, 0:size]
    cases = []
    for i in range(num_cases):
        img = rng.normal(0.0, 0.1, size=(size, size, size)).astype(np.float32)
        cz, cy, cx = rng.integers(8, size - 8, size=3)
        r = rng.integers(4, size // 4)
        mask = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
        img[mask] += 1.0
        cases.append({"image": img, "label": mask.astype(np.uint8), "case": f"synthbrats{i:03d}"})
    return cases


def synthetic_acdc(num_slices: int, num_volumes: int, slice_size: int, vol_depth: int,
                   num_classes: int = 4, seed: int = 0) -> tuple[list[dict], list[dict]]:
    """(train slices, val volumes) as `make_synthetic_acdc` writes them:
    dicts {"image", "label", "case"} of [S, S] slices and [vol_depth, S, S]
    volumes, S = `slice_size`; noise N(0, 0.1^2) with one disc per
    foreground class of intensity +0.5 * class, the label the class inside
    it. Slices are drawn first, then the volumes, from one generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:slice_size, 0:slice_size]

    def make_pair():
        label = np.zeros((slice_size, slice_size), dtype=np.uint8)
        image = rng.normal(0.0, 0.1, size=(slice_size, slice_size)).astype(np.float32)
        for cls in range(1, num_classes):
            cy, cx = rng.integers(4, slice_size - 4), rng.integers(4, slice_size - 4)
            r = rng.integers(2, max(3, slice_size // 6))
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
            label[mask] = cls
            image[mask] += 0.5 * cls
        return image, label

    slices = []
    for i in range(num_slices):
        image, label = make_pair()
        slices.append({"image": image, "label": label, "case": f"synth{i:03d}_slice_{i}"})
    volumes = []
    for i in range(num_volumes):
        pairs = [make_pair() for _ in range(vol_depth)]
        volumes.append({"image": np.stack([p[0] for p in pairs]),
                        "label": np.stack([p[1] for p in pairs]), "case": f"synthvol{i:03d}"})
    return slices, volumes


def make_synthetic_amos(root: str, num_cases: int = 4, shape=(96, 96, 72), spacing=(2.0, 2.0, 3.0),
                        num_classes: int = 16, seed: int = 0) -> str:
    """A Decathlon-style AMOS22 tree under `root`: imagesTr/ and labelsTr/
    `.nii.gz` volumes of `shape` at `spacing` (CT-like noise N(60, 50^2)
    with up to five spherical organs of +120, labelled 1..5) and
    `dataset_semi_ct.json` listing all cases but the last for training
    and the last for validation. At the protocol's (1.5, 1.5, 2.0) spacing
    the default volumes resample to about 127 x 127 x 107 voxels, large
    enough for 96^3 crops. Returns the JSON's path."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imagesTr")
    lab_dir = os.path.join(root, "labelsTr")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    training = []
    for i in range(num_cases):
        img = rng.normal(60.0, 50.0, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.uint8)
        for organ in range(1, min(num_classes, 6)):
            cz, cy, cx = rng.integers(12, np.asarray(shape) - 12)
            r = int(rng.integers(4, 10))
            mask = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
            lab[mask] = organ
            img[mask] += 120.0
        name = f"amos_{i:04d}.nii.gz"
        save_nifti(os.path.join(img_dir, name), img, affine)
        save_nifti(os.path.join(lab_dir, name), lab, affine)
        training.append({"image": f"imagesTr/{name}", "label": f"labelsTr/{name}"})
    jpath = os.path.join(root, "dataset_semi_ct.json")
    with open(jpath, "w") as f:
        json.dump({"training": training[:-1], "validation": training[-1:]}, f)
    return jpath
