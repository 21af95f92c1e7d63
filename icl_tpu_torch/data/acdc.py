"""ACDC h5 slices and volumes (counterpart of `icl_tpu/data/acdc.py`).

On-disk layout: {root}/train_slices.list and {root}/val_test.list (one id
per line; a list missing from the root is taken from the repo's vendored
copy under `data/ACDC/`), {root}/slices/{id}.h5 and {root}/volumes/{id}.h5
with 'image' and 'label' ([H, W] per slice, [D, H, W] per volume). Train
items are 2D slices, val items whole volumes; the labeled subset is a
prefix of the train list, `patients_to_slices` slices long.
"""
from __future__ import annotations

import os
from typing import Optional

from icl_tpu_torch.data.manifests import resolve_manifest

# ACDC patient count -> labeled slice count (train_inherent_consistent_unet_2D.py:52-62)
ACDC_PATIENTS_TO_SLICES = {3: 68, 7: 136, 14: 256, 21: 396, 28: 512, 35: 664, 140: 1312}
_PROSTATE_PATIENTS_TO_SLICES = {2: 27, 4: 53, 8: 120, 12: 179, 16: 256, 21: 312, 42: 623}


def patients_to_slices(dataset_path: str, patients_num: int) -> int:
    table = ACDC_PATIENTS_TO_SLICES if "ACDC" in dataset_path else _PROSTATE_PATIENTS_TO_SLICES
    return table[int(patients_num)]


class ACDCDataset:
    """Slice (train) or volume (val_test) reader; `cache` keeps the decoded
    arrays after the first read."""

    def __init__(self, base_dir: str, split: str = "train", num: Optional[int] = None,
                 cache: bool = True):
        self.base_dir = base_dir
        self.split = split
        list_file = "train_slices.list" if split == "train" else "val_test.list"
        with open(resolve_manifest(base_dir, list_file, "ACDC")) as f:
            self.sample_list = [ln.strip() for ln in f if ln.strip()]
        if num is not None and split == "train":
            self.sample_list = self.sample_list[:num]
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, idx: int) -> dict:
        if self._cache is not None and idx in self._cache:
            image, label = self._cache[idx]
        else:
            import h5py  # only the reader needs it

            sub = "slices" if self.split == "train" else "volumes"
            with h5py.File(os.path.join(self.base_dir, sub, f"{self.sample_list[idx]}.h5"), "r") as f:
                image, label = f["image"][:], f["label"][:]
            if self._cache is not None:
                self._cache[idx] = (image, label)
        return {"image": image, "label": label, "idx": idx, "case": self.sample_list[idx]}
