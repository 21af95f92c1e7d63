"""ACDC training batches (counterpart of `acdc_train_batches`,
`icl_tpu/data/pipeline.py:22-53`), channel-first."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from icl_tpu_torch.data.sampler import two_stream_batches
from icl_tpu_torch.data.transforms import RandomGenerator


def acdc_train_batches(dataset, labeled_count: int, batch_size: int, labeled_bs: int, patch_size,
                       seed: int = 1337) -> Iterator[dict]:
    """Endless [labeled..., unlabeled...] batches of augmented slices:
    "image" [B, 1, H, W] f32 and "label" [B, H, W] uint8. `dataset` is
    anything indexable whose items hold "image" and "label" slices (an
    `ACDCDataset`, or a list of in-memory slices); indices below
    `labeled_count` are the labeled ones."""
    transform = RandomGenerator(patch_size)
    aug_rng = np.random.default_rng(seed + 1)
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, len(dataset))),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        pairs = [transform(dataset[i]["image"], dataset[i]["label"], aug_rng) for i in idxs]
        yield {"image": np.stack([img for img, _ in pairs])[:, None],
               "label": np.stack([lab for _, lab in pairs])}
