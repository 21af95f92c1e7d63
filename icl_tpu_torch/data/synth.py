"""Seeded synthetic BraTS cases and ACDC slices and volumes in memory (the
arrays of `icl_tpu/data/synth.py`'s `make_synthetic_brats` and
`make_synthetic_acdc`, drawn in the same order, without the h5 files)."""
from __future__ import annotations

import numpy as np


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
