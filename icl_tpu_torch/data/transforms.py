"""Host-side 2D augmentations of the ACDC training pipeline (counterpart
of `icl_tpu/data/transforms.py`): the reference `RandomGenerator`, 50%
rot90 by k in {0..3} then a flip along a random axis, else 25% a rotation
by an integer angle in [-20, 20) (order 0, same shape), then an order-0
zoom to the patch; and the FixMatch pairs, `WeakStrongAugment` (rot/flip,
then a colour jitter) and `CTATransform` (CTAugment policies). Every draw
comes from the numpy Generator passed in, in the JAX package's order, so
one seed gives the same arrays in both packages. The pairs come out
channel-first.

The rotation and the zoom are routed as in the JAX package: where
`native.available()` (a C++ compiler is found), the rotation runs in
`icl_tpu_torch.native` (the image cast to float32, the label as it is),
and so does every order-0 zoom of a 2D float32 or uint8 array; every
other zoom, and both without a compiler, run in scipy.ndimage, as in the
reference. Both give the same pixels."""
from __future__ import annotations

import numpy as np
from scipy import ndimage

from icl_tpu_torch import native
from icl_tpu_torch.data.ctaugment import cta_apply


def random_rot_flip(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    k = int(rng.integers(0, 4))
    axis = int(rng.integers(0, 2))
    image = np.flip(np.rot90(image, k), axis=axis).copy()
    label = np.flip(np.rot90(label, k), axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    angle = int(rng.integers(-20, 20))
    if native.available():
        return (native.rotate_nearest(image.astype(np.float32), angle),
                native.rotate_nearest(label, angle))
    return (ndimage.rotate(image, angle, order=0, reshape=False),
            ndimage.rotate(label, angle, order=0, reshape=False))


def zoom_to(image: np.ndarray, output_size, order: int = 0) -> np.ndarray:
    """scipy's zoom of a 2D array to `output_size` (dataset.py:161-162),
    through `native.zoom_nearest` where the module docstring says."""
    if (order == 0 and image.ndim == 2 and image.dtype in (np.float32, np.uint8)
            and native.available()):
        return native.zoom_nearest(image, output_size)
    x, y = image.shape
    return ndimage.zoom(image, (output_size[0] / x, output_size[1] / y), order=order)


def color_jitter(image: np.ndarray, rng: np.random.Generator, s: float = 1.0) -> np.ndarray:
    """What torchvision's ColorJitter(0.8s, 0.8s, 0.8s, 0.2s) does to a
    grayscale image: brightness and contrast factors drawn in
    [max(0, 1 - 0.8s), 1 + 0.8s] (saturation and hue leave one channel
    as it is), clipped to [0, 1]."""
    lo = max(0.0, 1.0 - 0.8 * s)
    hi = 1.0 + 0.8 * s
    b = rng.uniform(lo, hi)
    c = rng.uniform(lo, hi)
    out = image * b
    mean = out.mean()
    out = (out - mean) * c + mean
    return np.clip(out, 0.0, 1.0).astype(np.float32)


class WeakStrongAugment:
    """The FixMatch weak (rot/flip) and strong (colour jitter on the weak
    image) pair of one slice zoomed to the patch (dataset.py:169-202):
    "image", "image_weak", "image_strong" [1, h, w] float32, "label_aug"
    [h, w] uint8."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, image, label, rng: np.random.Generator) -> dict:
        image = zoom_to(image, self.output_size, order=0)
        label = zoom_to(label, self.output_size, order=0)
        image_weak, label = random_rot_flip(image, label, rng)
        image_strong = color_jitter(image_weak, rng)
        return {"image": image.astype(np.float32)[None],
                "image_weak": image_weak.astype(np.float32)[None],
                "image_strong": image_strong.astype(np.float32)[None],
                "label_aug": label.astype(np.uint8)}


class CTATransform:
    """The CTAugment pair of one slice (dataset.py:106-144): zoomed to the
    patch, the weak policy on the image and on its label (scaled by 1/255
    and back), the strong policy on top of the weak image: "image_weak",
    "image_strong" [1, h, w] float32, "label_aug" [h, w] int32. `rng` draws
    `cutout`'s centres, the image's and then the label's
    (`ctaugment.cta_apply`)."""

    def __init__(self, output_size, cta):
        self.output_size = tuple(output_size)
        self.cta = cta

    def __call__(self, image, label, ops_weak, ops_strong,
                 rng: np.random.Generator | None = None) -> dict:
        image = zoom_to(image, self.output_size, order=0)
        label = zoom_to(label, self.output_size, order=0)
        image_weak = cta_apply(image.astype(np.float32), ops_weak, rng)
        image_strong = cta_apply(image_weak, ops_strong, rng)
        label_aug = cta_apply(label.astype(np.float32) / 255.0, ops_weak, rng)
        return {"image_weak": image_weak[None], "image_strong": image_strong[None],
                "label_aug": np.round(255 * label_aug).astype(np.int32)}


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
