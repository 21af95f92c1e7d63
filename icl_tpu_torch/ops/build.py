"""Build step for the port's CUDA kernels.

Each kernel source under `ops/csrc/` has a plain C interface and is
compiled with `nvcc` into a shared library that `ctypes` loads: no
PyTorch headers, so a build takes seconds. The library lands in
`<repo>/build/<name>-<hash>/`, keyed by the hash of the source, the
headers under `ops/csrc/` and the flags, and is built at first use.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def build_library(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` into `lib<name>.so` unless a build of the
    same source, headers and flags exists. Returns (library path,
    compiler log); the log is empty when the library was already built."""
    source = CSRC / f"{name}.cu"
    key = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_window_attention() -> ctypes.CDLL:
    """The window-attention library, built on first use, with its C
    signatures declared."""
    path, _ = build_library("window_attention")
    lib = ctypes.CDLL(str(path))
    fn = lib.icl_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_geometry(lib.icl_window_attention_fwd_geometry)
    _declare_error_string(lib)
    return lib


@functools.cache
def load_window_attention_bwd() -> ctypes.CDLL:
    """The window-attention backward library, built on first use, with its
    C signatures declared."""
    path, _ = build_library("window_attention_bwd")
    lib = ctypes.CDLL(str(path))
    fn = lib.icl_window_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_geometry(lib.icl_window_attention_bwd_geometry)
    _declare_error_string(lib)
    return lib


@functools.cache
def load_sgd_bf16() -> ctypes.CDLL:
    """The bf16 stochastic-rounding SGD library, built on first use, with
    its C signature declared."""
    path, _ = build_library("sgd_bf16")
    lib = ctypes.CDLL(str(path))
    fn = lib.icl_sgd_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_error_string(lib)
    return lib


def _declare_geometry(fn) -> None:
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int


def _declare_error_string(lib: ctypes.CDLL) -> None:
    lib.icl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icl_cuda_error_string.restype = ctypes.c_char_p
