"""MONAI-equivalent Spacing resampler (a copy of `icl_tpu/data/resample.py`).

The reference resamples AMOS volumes with MONAI 1.0.1's Spacingd
(train_inherent_consistent_unet_3D_AMOS22.py:98-103,146-151), which is
torch `grid_sample` under the hood: `Spacing` -> `SpatialResample` ->
`AffineTransform` -> `affine_grid` + `grid_sample(mode, padding_mode=
'border', align_corners=False)`. This module reproduces it in numpy:

  1. `zoom_affine`          - Cholesky factorization of the affine's
                              rotation-zoom-shear block: the orthonormal
                              rotation kept, the zooms replaced by pixdim,
                              the shear dropped (monai.data.utils.zoom_affine,
                              diagonal=False).
  2. `compute_shape_offset` - output shape = round(ptp(corners) + 1) over
                              the 8 input-corner voxels mapped through
                              inv(new_affine) @ old_affine; the offset
                              anchors the min corner (monai.data.utils).
  3. `affine_resample`      - dst voxel grid -> src voxel coords via
                              inv(src_affine) @ dst_affine, then
                              grid_sample semantics: border padding clips
                              the coords to [0, size - 1] before
                              interpolating; 'bilinear' is trilinear on the
                              clipped coords, 'nearest' rounds half to even
                              (torch's nearbyint).
"""
from __future__ import annotations

from itertools import product

import numpy as np


def zoom_affine(affine: np.ndarray, pixdim, diagonal: bool = False) -> np.ndarray:
    """monai.data.utils.zoom_affine (MONAI 1.0.1), diagonal=False: QR-
    style Cholesky factorization rzs = rotation @ zs — the orthonormal
    `rotation` keeps direction, `zs`'s diagonal signs keep axis
    orientation, and the new zooms replace |diag(zs)|. For shear-free
    affines this equals rescaling the columns to the target norms; for
    sheared affines the Cholesky construction additionally DROPS the
    shear (upper-triangular part of zs), exactly as MONAI does.
    Translation is zeroed — Spacing re-anchors it from the offset."""
    affine = np.array(np.asarray(affine, np.float64), copy=True)
    d = len(affine) - 1
    pixdim = np.asarray(pixdim, np.float64)[:d]
    if len(pixdim) < d:
        norms = np.sqrt((affine[:-1, :-1] ** 2).sum(axis=0))[: d]
        pixdim = np.append(pixdim, norms[len(pixdim):])
    pixdim = np.where(pixdim == 0, 1.0, pixdim)
    if diagonal:
        return np.diag(np.append(pixdim, [1.0]))
    rzs = affine[:-1, :-1]
    zs = np.linalg.cholesky(rzs.T @ rzs).T
    rotation = rzs @ np.linalg.inv(zs)
    s = np.sign(np.diag(zs)) * np.abs(pixdim)
    out = np.eye(len(affine))
    out[:-1, :-1] = rotation @ np.diag(s)
    return out


def compute_shape_offset(spatial_shape, in_affine: np.ndarray,
                         out_affine: np.ndarray):
    """Output spatial shape + world offset of the resampled volume
    (monai.data.utils.compute_shape_offset)."""
    shape = np.asarray(spatial_shape, np.float64)
    sr = len(shape)
    corners = np.asarray(
        np.meshgrid(*[(0.0, d - 1.0) for d in shape], indexing="ij")
    ).reshape(sr, -1)
    corners = np.concatenate([corners, np.ones_like(corners[:1])])
    corners_world = np.asarray(in_affine, np.float64) @ corners
    inv_out = np.linalg.inv(np.asarray(out_affine, np.float64))
    corners_out = inv_out @ corners_world
    corners_out = corners_out[:-1] / corners_out[-1]
    out_shape = np.round(np.ptp(corners_out, axis=1) + 1.0).astype(int)
    # offset = the input corner that lands at the output's min index
    mat = inv_out[:-1, :-1]
    k = 0
    for i in range(corners_world.shape[1]):
        min_corner = np.min(
            mat @ corners_world[:-1] - corners_out[:, i : i + 1], axis=1
        )
        if np.allclose(min_corner, 0.0, atol=1e-7):
            k = i
            break
    offset = corners_world[:-1, k]
    return out_shape, offset


def _grid_sample_np(vol: np.ndarray, coords: np.ndarray, mode: str) -> np.ndarray:
    """torch.nn.functional.grid_sample semantics on source VOXEL coords
    (already unnormalized), padding_mode='border'.

    vol: [D0, D1, D2]; coords: [3, *out_shape] (per-axis src coords)."""
    out_shape = coords.shape[1:]
    # border padding: clip the coordinate itself before interpolating
    c = np.empty_like(coords)
    for a in range(3):
        c[a] = np.clip(coords[a], 0.0, vol.shape[a] - 1.0)
    if mode == "nearest":
        # torch rounds with std::nearbyint = round-half-to-even = np.rint
        idx = tuple(np.rint(c[a]).astype(np.int64) for a in range(3))
        return vol[idx]
    if mode != "bilinear":
        raise ValueError(mode)
    lo = np.floor(c).astype(np.int64)
    frac = c - lo
    out = np.zeros(out_shape, np.float64)
    for bits in product((0, 1), repeat=3):
        w = np.ones(out_shape, np.float64)
        idx = []
        for a, b in enumerate(bits):
            w = w * (frac[a] if b else 1.0 - frac[a])
            idx.append(np.clip(lo[a] + b, 0, vol.shape[a] - 1))
        out += w * vol[tuple(idx)].astype(np.float64)
    return out


def affine_resample(vol: np.ndarray, src_affine: np.ndarray,
                    dst_affine: np.ndarray, out_shape, mode: str) -> np.ndarray:
    """Resample `vol` so that dst voxel j holds the value at source
    voxel inv(src_affine) @ dst_affine @ j (SpatialResample semantics,
    border padding, align_corners=False — the normalize/unnormalize
    round trip of affine_grid+grid_sample cancels to exactly this
    voxel-to-voxel map)."""
    xform = np.linalg.inv(np.asarray(src_affine, np.float64)) @ np.asarray(
        dst_affine, np.float64
    )
    grids = list(np.meshgrid(
        *[np.arange(s, dtype=np.float64) for s in out_shape], indexing="ij"
    ))
    dst = np.stack(grids + [np.ones_like(grids[0])])  # [4, *out_shape]
    src = np.einsum("ij,j...->i...", xform[:3], dst)  # [3, *out_shape]
    return _grid_sample_np(vol, src, mode)


def monai_spacing_resample(data: np.ndarray, affine: np.ndarray,
                           pixdim=(1.5, 1.5, 2.0), mode: str = "bilinear"):
    """MONAI `Spacing(pixdim, diagonal=False, mode, padding_mode=
    'border', align_corners=False)` on one 3D volume. Returns
    (resampled [float32 for bilinear / input dtype for nearest],
    new_affine)."""
    affine = np.asarray(affine, np.float64)
    new_affine = zoom_affine(affine, pixdim)
    out_shape, offset = compute_shape_offset(data.shape, affine, new_affine)
    new_affine[:3, 3] = offset
    out = affine_resample(
        data.astype(np.float64), affine, new_affine, out_shape, mode
    )
    if mode == "nearest":
        return out.astype(data.dtype), new_affine
    return out.astype(np.float32), new_affine
