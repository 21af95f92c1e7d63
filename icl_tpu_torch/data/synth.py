"""Seeded synthetic BraTS cases in memory (the volumes of
`icl_tpu/data/synth.py:make_synthetic_brats`, drawn in the same order,
without the h5 files): noise N(0, 0.1^2) with a spherical whole tumour
of intensity +1, label 1 inside it."""
from __future__ import annotations

import numpy as np


def synthetic_brats_cases(num_cases: int, size: int, seed: int = 0) -> list[dict]:
    """`num_cases` dicts {"image" [size]^3 f32, "label" [size]^3 uint8,
    "case"}; the same seed gives the same volumes as the h5 fixture."""
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
