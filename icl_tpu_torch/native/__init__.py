"""Order-0 zoom and order-0 rotate of 2D host arrays in C++ (counterpart
of `icl_tpu/native`), the same pixels as scipy.ndimage's: also where a
zoom's last source coordinate rounds past the input and scipy writes 0,
where the JAX module's library copies the last input row (`augment.cpp`).

The source is the port's own copy, `augment.cpp` beside this file. It is
built with the host's C++ compiler (`$CXX`, else `g++`) at the first call
(`ops/build.py:build_host_library`, into `build/augment-<hash>/`) and
called through `ctypes`, which releases the GIL: a `Prefetcher` thread
zooms beside the step's thread.

`available()` is False only where no C++ compiler is found, which is
logged once; `zoom_nearest` and `rotate_nearest` then compute with scipy,
as the JAX module does without its library. A compiler that fails on the
source, or a library that does not load, raises. Dtypes as the JAX
module's: float32 in gives float32 out, anything else is cast to uint8.
`zoom_nearest.calls` and `rotate_nearest.calls` count the calls that
reached the library in this process (`reset_call_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import logging
import threading
from pathlib import Path

import numpy as np
from scipy import ndimage

from icl_tpu_torch.ops import build

SOURCE = Path(__file__).resolve().parent / "augment.cpp"
_LOCK = threading.Lock()
_F32, _U8 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _load(source: Path) -> ctypes.CDLL | None:
    cxx = build.find_cxx()
    if cxx is None:
        logging.getLogger(__name__).warning(
            "no C++ compiler found ($CXX, g++): the order-0 zoom and rotate run in scipy")
        return None
    path, _ = build.build_host_library(source, cxx)
    lib = ctypes.CDLL(str(path))
    for name, ptr in (("f32", _F32), ("u8", _U8)):
        zoom, rotate = getattr(lib, f"zoom_nearest_{name}"), getattr(lib, f"rotate_nearest_{name}")
        zoom.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ptr, ctypes.c_int, ctypes.c_int]
        rotate.argtypes = [ptr, ctypes.c_int, ctypes.c_int, ctypes.c_float, ptr]
        zoom.restype = rotate.restype = None
    return lib


def _library() -> ctypes.CDLL | None:
    """The library, built and loaded by the first caller of any thread."""
    with _LOCK:
        return _load(SOURCE)


def available() -> bool:
    return _library() is not None


def _typed(img: np.ndarray) -> tuple[np.ndarray, type, str]:
    if img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"a non-empty 2D array is needed, got shape {img.shape}")
    if img.dtype == np.float32:
        return np.ascontiguousarray(img), _F32, "f32"
    return np.ascontiguousarray(img.astype(np.uint8)), _U8, "u8"


def _counted(fn) -> None:
    with _LOCK:
        fn.calls += 1


def zoom_nearest(img: np.ndarray, out_size) -> np.ndarray:
    """scipy.ndimage.zoom(img, order=0) of a 2D array to `out_size`."""
    oh, ow = int(out_size[0]), int(out_size[1])
    lib = _library()
    if lib is None:
        h, w = img.shape
        return ndimage.zoom(img, (oh / h, ow / w), order=0)
    if oh < 1 or ow < 1:
        raise ValueError(f"output size {out_size}")
    img, ptr, name = _typed(img)
    out = np.empty((oh, ow), img.dtype)
    getattr(lib, f"zoom_nearest_{name}")(img.ctypes.data_as(ptr), img.shape[0], img.shape[1],
                                         out.ctypes.data_as(ptr), oh, ow)
    _counted(zoom_nearest)
    return out


def rotate_nearest(img: np.ndarray, angle: float) -> np.ndarray:
    """scipy.ndimage.rotate(img, angle, order=0, reshape=False) of a 2D
    array, 0 outside."""
    lib = _library()
    if lib is None:
        return ndimage.rotate(img, angle, order=0, reshape=False)
    img, ptr, name = _typed(img)
    out = np.empty_like(img)
    getattr(lib, f"rotate_nearest_{name}")(img.ctypes.data_as(ptr), img.shape[0], img.shape[1],
                                           float(angle), out.ctypes.data_as(ptr))
    _counted(rotate_nearest)
    return out


def reset_call_counts() -> None:
    with _LOCK:
        zoom_nearest.calls = rotate_nearest.calls = 0


reset_call_counts()
