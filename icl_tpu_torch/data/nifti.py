"""Minimal NIfTI-1 reader and writer (a copy of `icl_tpu/data/nifti.py`;
numpy, gzip and struct, no nibabel).

Supports .nii / .nii.gz, the datatypes AMOS CT uses (uint8, int16/32,
float32/64), scl_slope/scl_inter scaling, and the sform/qform affine:
enough for MONAI's LoadImaged + Orientationd("RAS") + Spacingd in the
AMOS pipeline (train_inherent_consistent_unet_3D_AMOS22.py:84-159).
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


@dataclass
class NiftiVolume:
    data: np.ndarray  # [X, Y, Z] (first 3 dims)
    affine: np.ndarray  # 4x4 voxel->world


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if hdr["pixdim"][0] < 0 else 1.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    spacing = np.array([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * spacing
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def load_nifti(path: str) -> NiftiVolume:
    with _open(path) as f:
        raw = f.read()
    hdr_size = struct.unpack_from("<i", raw, 0)[0]
    if hdr_size != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={hdr_size})")
    dim = struct.unpack_from("<8h", raw, 40)
    datatype = struct.unpack_from("<h", raw, 70)[0]
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = struct.unpack_from("<f", raw, 108)[0]
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    qform_code = struct.unpack_from("<h", raw, 252)[0]
    sform_code = struct.unpack_from("<h", raw, 254)[0]
    quat = struct.unpack_from("<6f", raw, 256)
    srow = np.array(struct.unpack_from("<12f", raw, 280)).reshape(3, 4)
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    ndim = dim[0]
    shape = tuple(dim[1 : 1 + max(ndim, 3)])
    shape = tuple(max(s, 1) for s in shape[:3])  # first 3 spatial dims
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dtype, count=count, offset=int(vox_offset)
    ).reshape(shape, order="F")
    data = np.asarray(data)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = srow
    elif qform_code > 0:
        hdr = {
            "pixdim": pixdim,
            "quatern_b": quat[0], "quatern_c": quat[1], "quatern_d": quat[2],
            "qoffset_x": quat[3], "qoffset_y": quat[4], "qoffset_z": quat[5],
        }
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return NiftiVolume(data=data, affine=affine)


def save_nifti(path: str, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a float32/int NIfTI-1 file (tests + preprocessing output)."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    code = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
            np.dtype(np.float32): 16, np.dtype(np.float64): 64}[data.dtype]
    bitpix = data.dtype.itemsize * 8
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [3, *data.shape[:3], 1, 1, 1, 1]
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *affine[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


_ORIENT_LABELS = (("R", "L"), ("A", "P"), ("S", "I"))


def orientation_codes(affine: np.ndarray) -> list[tuple[int, int]]:
    """For each voxel axis: (world_axis, sign) of its dominant direction."""
    R = affine[:3, :3]
    out = []
    used = set()
    for ax in range(3):
        col = R[:, ax]
        order = np.argsort(-np.abs(col))
        world = next(int(w) for w in order if int(w) not in used)
        used.add(world)
        out.append((world, 1 if col[world] >= 0 else -1))
    return out


def to_ras(data: np.ndarray, affine: np.ndarray):
    """Reorder/flip voxel axes so axis i increases along world axis i
    (RAS+), as MONAI Orientationd(axcodes='RAS'). Returns (data, affine)."""
    codes = orientation_codes(affine)
    perm = [0, 0, 0]
    flips = []
    for vox_ax, (world_ax, sign) in enumerate(codes):
        perm[world_ax] = vox_ax
    data = np.transpose(data, perm)
    new_affine = affine.copy()
    new_affine[:3, :3] = affine[:3, :3][:, perm]
    for ax in range(3):
        if new_affine[ax, ax] < 0:
            data = np.flip(data, axis=ax)
            n = data.shape[ax]
            new_affine[:3, 3] += new_affine[:3, ax] * (n - 1)
            new_affine[:3, ax] *= -1
    return np.ascontiguousarray(data), new_affine


def voxel_spacing(affine: np.ndarray) -> np.ndarray:
    return np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
