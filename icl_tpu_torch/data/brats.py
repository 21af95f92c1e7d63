"""BraTS2019 h5 volumes for evaluation (counterpart of the dataset class
of `icl_tpu/data/brats.py` and the manifest lookup of
`icl_tpu/data/manifests.py`).

On-disk layout: {root}/{split list}.txt and {root}/data/{case}.h5 with
'image' [W, H, D] float and 'label' [W, H, D]. A split list missing from
the root is taken from the repo's vendored copy under `data/BraTS2019/`.
"""
from __future__ import annotations

import os

import numpy as np

VENDORED_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data", "BraTS2019"
)


def resolve_manifest(base_dir: str, filename: str) -> str:
    """The dataset root's own list if present, else the vendored one,
    else the root path (so open() names the path the user asked for)."""
    for path in (os.path.join(base_dir, filename), os.path.join(VENDORED_ROOT, filename)):
        if os.path.exists(path):
            return path
    return os.path.join(base_dir, filename)


class BraTS2019Dataset:
    def __init__(self, base_dir: str, split: str = "val_test"):
        self.base_dir = base_dir
        list_file = {"train": "train.txt", "test": "val.txt",
                     "val_test": "val_test.txt"}.get(split, f"{split}.txt")
        with open(resolve_manifest(base_dir, list_file)) as f:
            self.image_list = [ln.strip().split(",")[0] for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.image_list)

    def __getitem__(self, idx: int) -> dict:
        import h5py  # only the reader needs it

        case = self.image_list[idx]
        with h5py.File(os.path.join(self.base_dir, "data", f"{case}.h5"), "r") as f:
            image = f["image"][:]
            label = f["label"][:].astype(np.uint8)
        return {"image": image, "label": label, "case": case}
