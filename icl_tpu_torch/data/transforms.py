"""Host-side 2D augmentations of the ACDC training pipeline (counterpart
of `icl_tpu/data/transforms.py`, the reference `RandomGenerator`):
50% rot90 by k in {0..3} then a flip along a random axis, else 25% a
rotation by an integer angle in [-20, 20) (order 0, same shape), then an
order-0 zoom to the patch. Every draw comes from the numpy Generator
passed in, in the JAX package's order, so one seed gives the same arrays
in both packages. scipy computes the rotation and the zoom, as in the
reference (the JAX package may route them through its own C++ helpers)."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def random_rot_flip(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    k = int(rng.integers(0, 4))
    axis = int(rng.integers(0, 2))
    image = np.flip(np.rot90(image, k), axis=axis).copy()
    label = np.flip(np.rot90(label, k), axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    angle = int(rng.integers(-20, 20))
    return (ndimage.rotate(image, angle, order=0, reshape=False),
            ndimage.rotate(label, angle, order=0, reshape=False))


def zoom_to(image: np.ndarray, output_size, order: int = 0) -> np.ndarray:
    """scipy zoom of a 2D array to `output_size` (dataset.py:161-162)."""
    x, y = image.shape
    return ndimage.zoom(image, (output_size[0] / x, output_size[1] / y), order=order)


class RandomGenerator:
    """(image [H, W], label [H, W]) -> (image [h, w] float32, label
    [h, w] uint8) at the patch size (h, w)."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
        if rng.random() > 0.5:
            image, label = random_rot_flip(image, label, rng)
        elif rng.random() > 0.5:
            image, label = random_rotate(image, label, rng)
        image = zoom_to(image, self.output_size, order=0)
        label = zoom_to(label, self.output_size, order=0)
        return image.astype(np.float32), label.astype(np.uint8)
