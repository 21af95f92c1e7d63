"""The 2D augmentations on the device (counterpart of
`icl_tpu/data/device_augment.py`): the reference's host pipeline (rot90 and
flip, a +-20 degree order-0 rotate, the order-0 zoom; dataset.py:75-166)
as index maps and one gather per batch, so that they run on the card
inside the training step.

Per sample, as the JAX package draws them: with probability 1/2 a rot90
(k in 0..3) then a flip (axis 0 or 1); otherwise, with probability 1/2, a
rotate by an integer angle in [-20, 20) (nearest, reshape=False, 0
outside); then the order-0 zoom to the patch (scipy's grid_mode=False
index map). The draws are made on the host by `draw_augment_params` from a
seeded numpy generator and travel with the batch, so that the step stays
free of host work and can be captured in a CUDA graph (the JAX package
draws them with threefry inside the step; its bits cannot be matched).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

AUGMENT_KEYS = ("branch", "k", "axis", "angle")
NONE, ROT_FLIP, ROTATE = 0, 1, 2


def draw_augment_params(generator: np.random.Generator, batch: int) -> dict:
    """The per-sample draws of one batch, int64 arrays [batch]: "branch"
    (NONE, ROT_FLIP or ROTATE: 1/4, 1/2, 1/4), "k" (0..3), "axis" (0, 1),
    "angle" (an integer in [-20, 20)), each drawn for every sample as the
    JAX package draws every key."""
    u1, u2 = generator.random(batch), generator.random(batch)
    k = generator.integers(0, 4, batch)
    axis = generator.integers(0, 2, batch)
    angle = generator.integers(-20, 20, batch)
    branch = np.where(u1 > 0.5, ROT_FLIP, np.where(u2 > 0.5, ROTATE, NONE))
    return {"branch": branch.astype(np.int64), "k": k.astype(np.int64),
            "axis": axis.astype(np.int64), "angle": angle.astype(np.int64)}


def zoom_indices(in_size: int, out_size: int) -> np.ndarray:
    """scipy.ndimage.zoom(order=0, grid_mode=False)'s index map, in f32 as
    the JAX package computes it: in_idx = floor(out_idx * (in - 1) /
    (out - 1) + 0.5), clipped."""
    if out_size == 1:
        return np.zeros(1, np.int64)
    ratio = np.float32((in_size - 1) / (out_size - 1))
    idx = np.floor(np.arange(out_size, dtype=np.float32) * ratio + np.float32(0.5))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


@functools.lru_cache(maxsize=16)
def _zoom_indices_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`zoom_indices` as a device tensor, made once per geometry (at the
    first step, before a CUDA graph capture, which cannot copy from the
    host)."""
    with torch.inference_mode(False):
        return torch.from_numpy(zoom_indices(in_size, out_size)).to(device)


def zoom_nearest(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """Order-0 zoom of [..., S, S] to [..., out, out]."""
    idx = _zoom_indices_on(img.shape[-1], out_size, img.device)
    return img[..., idx, :][..., :, idx]


# cos and sin of the rotation angle theta = f32(-angle * pi / 180) for the
# integer angles -20..19, as the JAX package computes them (f32 jnp.cos and
# jnp.sin, XLA on the CPU), bit patterns. XLA's f32 sin lies one ulp from
# the correctly rounded value at +-7, +-13 and +-19 degrees, where torch's
# f32 sin on the CPU and on the card differ again; at +-13 degrees on a
# 255^2 slice that moves 2 nearest-neighbour sources. A table makes the
# rotation the JAX package's at every size, on every device.
ANGLES = (-20, 20)
_COS_BITS = (
    0x3f708fb2, 0x3f720d81, 0x3f737871, 0x3f74d063, 0x3f76153f, 0x3f7746ea, 0x3f78654d,
    0x3f797051, 0x3f7a67e2, 0x3f7b4beb, 0x3f7c1c5c, 0x3f7cd925, 0x3f7d8235, 0x3f7e1781,
    0x3f7e98fd, 0x3f7f069e, 0x3f7f605c, 0x3f7fa62f, 0x3f7fd814, 0x3f7ff605, 0x3f800000,
    0x3f7ff605, 0x3f7fd814, 0x3f7fa62f, 0x3f7f605c, 0x3f7f069e, 0x3f7e98fd, 0x3f7e1781,
    0x3f7d8235, 0x3f7cd925, 0x3f7c1c5c, 0x3f7b4beb, 0x3f7a67e2, 0x3f797051, 0x3f78654d,
    0x3f7746ea, 0x3f76153f, 0x3f74d063, 0x3f737871, 0x3f720d81)
_SIN_BITS = (
    0x3eaf1d44, 0x3ea6b0df, 0x3e9e377a, 0x3e95b1bf, 0x3e8d2057, 0x3e8483ee, 0x3e77ba61,
    0x3e665993, 0x3e54e6ce, 0x3e436370, 0x3e31d0d5, 0x3e20305c, 0x3e0e8365, 0x3df996a4,
    0x3dd61305, 0x3db27eb6, 0x3d8edc7b, 0x3d565e3b, 0x3d0ef2c6, 0x3c8ef859, 0x80000000,
    0xbc8ef859, 0xbd0ef2c6, 0xbd565e3b, 0xbd8edc7b, 0xbdb27eb6, 0xbdd61305, 0xbdf996a4,
    0xbe0e8365, 0xbe20305c, 0xbe31d0d5, 0xbe436370, 0xbe54e6ce, 0xbe665993, 0xbe77ba61,
    0xbe8483ee, 0xbe8d2057, 0xbe95b1bf, 0xbe9e377a, 0xbea6b0df)


@functools.lru_cache(maxsize=8)
def _cos_sin_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False):
        table = np.array([_COS_BITS, _SIN_BITS], np.uint32).view(np.float32)
        cos, sin = torch.from_numpy(table.copy()).to(device)
        return cos, sin


def _rotation_sources(angle: torch.Tensor, s: int):
    """(iy, ix, valid) [B, s, s]: the source of each output pixel of
    ndimage.rotate(order=0, reshape=False, cval=0) by `angle` degrees ([B]
    integers in [-20, 20)), as the JAX package's `_rotate_nearest`
    computes it in f32: output(o) = input(R(o - c) + c), nearest, valid
    where the unrounded source lies in [0, s - 1]."""
    cos_t, sin_t = _cos_sin_on(angle.device)
    cos = cos_t[angle - ANGLES[0]][:, None, None]
    sin = sin_t[angle - ANGLES[0]][:, None, None]
    c = (s - 1) / 2.0
    r = torch.arange(s, device=angle.device) - c
    yy, xx = r[None, :, None], r[None, None, :]
    src_y = cos * yy - sin * xx + c
    src_x = sin * yy + cos * xx + c
    valid = (src_y >= 0) & (src_y <= s - 1) & (src_x >= 0) & (src_x <= s - 1)
    iy = torch.floor(src_y + 0.5).to(torch.int64).clamp(0, s - 1)
    ix = torch.floor(src_x + 0.5).to(torch.int64).clamp(0, s - 1)
    return iy, ix, valid


def _rot_flip_sources(k: torch.Tensor, axis: torch.Tensor, s: int):
    """(iy, ix) [B, s, s] of np.rot90(a, k) followed by np.flip(., axis)
    on a square a: rot90 k times counter-clockwise, out[i, j] = a[j, n - i]
    for k 1, a[n - i, n - j] for 2, a[n - j, i] for 3 (n = s - 1)."""
    n = s - 1
    r = torch.arange(s, device=k.device)
    i, j = r[None, :, None].expand(1, s, s), r[None, None, :].expand(1, s, s)
    i = torch.where(axis[:, None, None] == 0, n - i, i)  # the flip acts on rot90's output
    j = torch.where(axis[:, None, None] == 1, n - j, j)
    kk = k[:, None, None]
    iy = torch.where(kk == 0, i, torch.where(kk == 1, j, torch.where(kk == 2, n - i, n - j)))
    ix = torch.where(kk == 0, j, torch.where(kk == 1, n - i, torch.where(kk == 2, n - j, i)))
    return iy, ix


def augment_batch(images: torch.Tensor, labels: torch.Tensor, params: dict,
                  out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """images [B, S, S] f32, labels [B, S, S] (any integer dtype), `params`
    (`draw_augment_params`' arrays as tensors on the same device) ->
    (images [B, 1, out, out] f32, labels [B, out, out] in their dtype).
    Per sample one source-index map at S, zoomed to out; then one gather
    for the images and one for the labels. Pixels whose rotated source
    lies outside the slice are 0 in both."""
    b, s = images.shape[0], images.shape[-1]
    if images.shape[-2] != s or labels.shape != images.shape:
        raise ValueError(f"augment_batch: square slices of one shape, got {tuple(images.shape)} "
                         f"and {tuple(labels.shape)}")
    branch = params["branch"]
    ry, rx = _rot_flip_sources(params["k"], params["axis"], s)
    ty, tx, valid = _rotation_sources(params["angle"], s)
    base = torch.arange(s, device=images.device)
    iy = torch.where(branch[:, None, None] == ROT_FLIP, ry,
                     torch.where(branch[:, None, None] == ROTATE, ty, base[None, :, None]))
    ix = torch.where(branch[:, None, None] == ROT_FLIP, rx,
                     torch.where(branch[:, None, None] == ROTATE, tx, base[None, None, :]))
    keep = valid | (branch[:, None, None] != ROTATE)
    z = _zoom_indices_on(s, out_size, images.device)
    src = (iy * s + ix)[:, z][:, :, z].reshape(b, -1)
    keep = keep[:, z][:, :, z].reshape(b, -1)
    img = torch.gather(images.reshape(b, -1), 1, src)
    lab = torch.gather(labels.reshape(b, -1), 1, src)
    img = torch.where(keep, img, torch.zeros((), dtype=img.dtype, device=img.device))
    lab = torch.where(keep, lab, torch.zeros((), dtype=lab.dtype, device=lab.device))
    return img.view(b, 1, out_size, out_size), lab.view(b, out_size, out_size)
