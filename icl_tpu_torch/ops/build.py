"""Build step for the port's CUDA kernels and its host C++ helper.

Each kernel source under `ops/csrc/` has a plain C interface and is
compiled with `nvcc` into a shared library that `ctypes` loads: no
PyTorch headers, so a build takes seconds. The host helper
(`native/augment.cpp`) is compiled the same way with the host's C++
compiler. A library lands in `<repo>/build/<name>-<hash>/`, keyed by the
hash of its source, its flags and, for a kernel, the headers under
`ops/csrc/`, for the host helper the compiler; it is built at first use.
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
# -split-compile=0: nvcc optimises and assembles a library's kernel
# instances (36 in the forward, 29 in the backward; 12 and 14 in their
# head-dim-chunked libraries, 12 and 14 in the streamed ones) on all the
# host's cores, so a cold build of
# the three libraries took 18 s instead of 30 s on the H100's 8-core host,
# with the same registers and spills per instance
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-split-compile=0",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# no -march=native: a library cached under build/ must run on any CPU of
# its architecture; no FMA contraction (GCC contracts by default on
# aarch64): a fused multiply-add rounds a coordinate's near-ties otherwise
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return nvcc


def find_cxx() -> str | None:
    """The host's C++ compiler, `$CXX` or else `g++`, as a path; None where
    there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def build_library(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` into `lib<name>.so` unless a build of the
    same source, headers and flags exists. Returns (library path,
    compiler log); the log is empty when the library was already built."""
    source = CSRC / f"{name}.cu"
    key = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return _compile(name, key + " ".join(NVCC_FLAGS).encode(),
                    [find_nvcc(), *NVCC_FLAGS, str(source)])


def build_host_library(source: Path, cxx: str) -> tuple[Path, str]:
    """Compile the C++ file `source` with the compiler `cxx` into
    `lib<stem>.so` unless a build of the same source, compiler and flags
    exists. Returns (library path, compiler log) as `build_library`."""
    key = source.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()
    return _compile(source.stem, key, [cxx, *CXX_FLAGS, str(source)])


def _compile(name: str, key: bytes, cmd: list) -> tuple[Path, str]:
    digest = hashlib.sha256(key).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_window_attention(wide: bool = False) -> ctypes.CDLL:
    """The window-attention library, built on first use, with its C
    signatures declared: head dims up to 64, or (`wide`) above 64, in
    64-column chunks (`window_attention_wide.cu`, `icl_window_attention_wide_*`)."""
    path, _ = build_library("window_attention_wide" if wide else "window_attention")
    lib = ctypes.CDLL(str(path))
    prefix = "icl_window_attention_wide" if wide else "icl_window_attention"
    fn = getattr(lib, f"{prefix}_fwd")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_geometry(getattr(lib, f"{prefix}_fwd_geometry"))
    _declare_error_string(lib)
    return lib


@functools.cache
def load_window_attention_bwd(wide: bool = False) -> ctypes.CDLL:
    """The window-attention backward library, built on first use, with its
    C signatures declared: head dims up to 64, or (`wide`) above 64
    (`window_attention_bwd_wide.cu`, `icl_window_attention_wide_*`)."""
    path, _ = build_library("window_attention_bwd_wide" if wide else "window_attention_bwd")
    lib = ctypes.CDLL(str(path))
    prefix = "icl_window_attention_wide" if wide else "icl_window_attention"
    fn = getattr(lib, f"{prefix}_bwd")
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_geometry(getattr(lib, f"{prefix}_bwd_geometry"))
    _declare_error_string(lib)
    return lib


@functools.cache
def load_window_attention_stream(backward: bool = False) -> ctypes.CDLL:
    """The streamed window-attention library, forward or (`backward`)
    backward, built on first use, with its C signatures declared: every
    head dim and window, the head dim's 64-column chunks streamed
    (`window_attention_stream.cu`, `window_attention_bwd_stream.cu`,
    `icl_window_attention_stream_*`)."""
    path, _ = build_library("window_attention_bwd_stream" if backward else "window_attention_stream")
    lib = ctypes.CDLL(str(path))
    what = "bwd" if backward else "fwd"
    fn = getattr(lib, f"icl_window_attention_stream_{what}")
    fn.argtypes = [ctypes.c_void_p] * (15 if backward else 8) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _declare_geometry(getattr(lib, f"icl_window_attention_stream_{what}_geometry"))
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
        ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int,
    ] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _declare_error_string(lib)
    return lib


def _declare_geometry(fn) -> None:
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int


def _declare_error_string(lib: ctypes.CDLL) -> None:
    lib.icl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.icl_cuda_error_string.restype = ctypes.c_char_p
