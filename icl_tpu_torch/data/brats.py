"""BraTS2019 h5 volumes and the training batches cut from them
(counterpart of `icl_tpu/data/brats.py`).

On-disk layout: {root}/{split list}.txt and {root}/data/{case}.h5 with
'image' [W, H, D] float and 'label' [W, H, D]. A split list missing from
the root is taken from the repo's vendored copy under `data/BraTS2019/`.

Training transforms (RandomRotFlip, then RandomCrop to the patch) draw
from numpy generators seeded as the JAX package's, in the same order, so
one seed gives the same batches in both packages; the batches here are
channel-first.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np

from icl_tpu_torch.data.manifests import resolve_manifest
from icl_tpu_torch.data.sampler import two_stream_batches


class BraTS2019Dataset:
    """The cases of one split list; `num` keeps its first `num` cases."""

    def __init__(self, base_dir: str, split: str = "val_test", num: Optional[int] = None):
        self.base_dir = base_dir
        list_file = {"train": "train.txt", "test": "val.txt",
                     "val_test": "val_test.txt"}.get(split, f"{split}.txt")
        with open(resolve_manifest(base_dir, list_file, "BraTS2019")) as f:
            self.image_list = [ln.strip().split(",")[0] for ln in f if ln.strip()]
        if num is not None:
            self.image_list = self.image_list[:num]

    def __len__(self) -> int:
        return len(self.image_list)

    def __getitem__(self, idx: int) -> dict:
        import h5py  # only the reader needs it

        case = self.image_list[idx]
        with h5py.File(os.path.join(self.base_dir, "data", f"{case}.h5"), "r") as f:
            image = f["image"][:]
            label = f["label"][:].astype(np.uint8)
        return {"image": image, "label": label, "case": case}


def _pad_to_fit(image, label, output_size):
    """Reference padding rule: if any dim <= target, pad both sides of
    every dim by (target - dim) // 2 + 3, clipped at 0."""
    if any(label.shape[i] <= output_size[i] for i in range(3)):
        pads = [(p, p) for p in (max((output_size[i] - label.shape[i]) // 2 + 3, 0) for i in range(3))]
        image = np.pad(image, pads, mode="constant", constant_values=0)
        label = np.pad(label, pads, mode="constant", constant_values=0)
    return image, label


def random_crop_3d(image, label, output_size, rng: np.random.Generator):
    """RandomCrop with the padding rule above."""
    image, label = _pad_to_fit(image, label, output_size)
    starts = [int(rng.integers(0, image.shape[i] - output_size[i])) for i in range(3)]
    sl = tuple(slice(s, s + o) for s, o in zip(starts, output_size))
    return image[sl], label[sl]


def center_crop_3d(image, label, output_size):
    """CenterCrop with the padding rule above: the crop's start in each
    axis is round((size - output) / 2)."""
    image, label = _pad_to_fit(image, label, output_size)
    starts = [int(round((image.shape[i] - output_size[i]) / 2.0)) for i in range(3)]
    sl = tuple(slice(s, s + o) for s, o in zip(starts, output_size))
    return image[sl], label[sl]


def random_noise_3d(image, rng: np.random.Generator, mu: float = 0.0, sigma: float = 0.1):
    """RandomNoise: image + clip(sigma * N(0, 1), -2 sigma, 2 sigma) + mu,
    the normals drawn from `rng` (no CLI uses it)."""
    noise = np.clip(sigma * rng.standard_normal(image.shape), -2 * sigma, 2 * sigma)
    return image + noise + mu


def create_onehot_label(label: np.ndarray, num_classes: int) -> np.ndarray:
    """CreateOnehotLabel, channel-first as the reference's: [C, *label.shape]
    f32 (no CLI uses it; the JAX package's is channel-last)."""
    label = np.asarray(label)
    return np.stack([(label == c).astype(np.float32) for c in range(num_classes)])


def random_rot_flip_3d(image, label, rng: np.random.Generator):
    """rot90 by k in {0..3} over the leading two axes, then a flip along
    axis 0 or 1."""
    k = int(rng.integers(0, 4))
    axis = int(rng.integers(0, 2))
    image = np.flip(np.rot90(image, k), axis=axis).copy()
    label = np.flip(np.rot90(label, k), axis=axis).copy()
    return image, label


def brats_train_batches(dataset, labeled_count: int, total_count: int, batch_size: int,
                        labeled_bs: int, patch_size: Sequence[int] = (96, 96, 96),
                        seed: int = 1337) -> Iterator[dict]:
    """Endless [labeled..., unlabeled...] batches: "image" [B, 1, *patch]
    f32 and "label" [B, *patch] uint8. `dataset` is anything indexable
    whose items hold "image" and "label" volumes (a BraTS2019Dataset, or
    a list of in-memory cases); indices below `labeled_count` are the
    labeled ones, the rest up to `total_count` the unlabeled ones."""
    aug_rng = np.random.default_rng(seed + 1)
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, total_count)),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        yield _augmented_batch(dataset, idxs, patch_size, aug_rng)


def brats_supervised_batches(dataset, batch_size: int, patch_size: Sequence[int] = (96, 96, 96),
                             seed: int = 1337) -> Iterator[dict]:
    """Endless labeled batches as `brats_train_batches` makes them, over
    one fresh permutation of the whole dataset per epoch (from `seed`;
    the remainder dropped), augmented from `seed + 1`. Raises if the
    dataset holds fewer cases than one batch (the JAX package's loop then
    spins without yielding)."""
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"{n} cases cannot fill a batch of {batch_size}")
    rng = np.random.default_rng(seed)
    aug_rng = np.random.default_rng(seed + 1)
    while True:
        perm = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            yield _augmented_batch(dataset, [int(i) for i in perm[start:start + batch_size]],
                                   patch_size, aug_rng)


def _augmented_batch(dataset, idxs, patch_size, aug_rng: np.random.Generator) -> dict:
    """RandomRotFlip then RandomCrop of each case, channel-first."""
    imgs, labs = [], []
    for i in idxs:
        item = dataset[i]
        img, lab = random_rot_flip_3d(item["image"], item["label"], aug_rng)
        img, lab = random_crop_3d(img, lab, patch_size, aug_rng)
        imgs.append(img.astype(np.float32)[None])
        labs.append(lab.astype(np.uint8))
    return {"image": np.stack(imgs), "label": np.stack(labs)}
