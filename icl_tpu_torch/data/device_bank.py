"""The ACDC training slices held in device memory (counterpart of
`icl_tpu/data/device_bank.py`): every slice resized once on the host to
one canonical square size and uploaded once; each step gathers its batch
by index and augments it on the card (`Trainer`'s device-augment step), so
that a step's host-to-device traffic is its indices and augment draws.

As in the JAX package, the slices are resized to the canonical size
before the rot90/flip/rotate, where the host pipeline augments first and
resizes after.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from icl_tpu_torch.data.device_augment import draw_augment_params
from icl_tpu_torch.data.sampler import two_stream_batches
from icl_tpu_torch.data.transforms import zoom_to


def build_acdc_bank(dataset, canon_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(image_bank [N, S, S] f32, label_bank [N, S, S] uint8) on `device`:
    each slice of `dataset` order-0 resized to canon_size^2 on the host,
    then one upload of each bank."""
    n = len(dataset)
    images = np.empty((n, canon_size, canon_size), np.float32)
    labels = np.empty((n, canon_size, canon_size), np.uint8)
    for i in range(n):
        item = dataset[i]
        images[i] = zoom_to(item["image"].astype(np.float32), (canon_size, canon_size))
        labels[i] = zoom_to(item["label"].astype(np.uint8), (canon_size, canon_size))
    return torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)


def two_stream_index_batches(labeled_count: int, total: int, batch_size: int, labeled_bs: int,
                             seed: int = 1337) -> Iterator[np.ndarray]:
    """Endless [labeled..., unlabeled...] index batches (int32), the
    two-stream sampler's, as `acdc_train_batches` draws them."""
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, total)),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        yield np.asarray(idxs, np.int32)


def supervised_index_batches(total: int, batch_size: int, seed: int = 1337) -> Iterator[np.ndarray]:
    """Endless labeled-only index batches (int32): one fresh permutation
    per epoch, the remainder dropped."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(total)
        for s in range(0, total - batch_size + 1, batch_size):
            yield np.asarray(perm[s:s + batch_size], np.int32)


def bank_batches(image_bank: torch.Tensor, label_bank: torch.Tensor, index_batches,
                 seed: int = 1337) -> Iterator[dict]:
    """The device-augment step's batches over a bank: {"image_bank",
    "label_bank" (the same tensors every step), "indices" (from
    `index_batches`), "augment" (`draw_augment_params` from a generator
    seeded `seed + 1`, the host pipeline's augment seed)}."""
    rng = np.random.default_rng(seed + 1)
    for idx in index_batches:
        yield {"image_bank": image_bank, "label_bank": label_bank, "indices": idx,
               "augment": draw_augment_params(rng, len(idx))}
