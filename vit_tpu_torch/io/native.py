"""ctypes binding to the native C++ reader ``native/vitio.cpp`` —
counterpart of ``vit_tpu.io.native``, with the same functions.

The port builds its own ``libvitio`` at first use: ``g++`` (``$CXX``) with
``native/Makefile``'s flags, into ``build/vit_tpu_torch/`` (where the CUDA
kernels' library goes), named by a hash of the flags and the source, as
``ops/kernels/_build.py`` names the kernels::

    g++ -O3 -fPIC -Wall -Wextra -std=c++17 -pthread -D_FILE_OFFSET_BITS=64 \
        -shared -o build/vit_tpu_torch/libvitio_<hash>.so native/vitio.cpp

It writes nothing into ``native/``.  Concurrent builds (test workers,
``torchrun`` ranks, threads) each compile to a name of their own and
``os.replace`` it into place, so none loads a partial file.  A build that
starts and fails raises ``RuntimeError``; only a missing compiler (or a
checkout without ``native/vitio.cpp``) leaves :func:`available` False, and
the datasets then read through numpy, as the JAX package does when its
library is absent.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "vitio.cpp"
BUILD_DIR = REPO_DIR / "build" / "vit_tpu_torch"  # ops/kernels/_build.BUILD_DIR
# native/Makefile's CXXFLAGS, then its link step's -shared
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-pthread",
            "-D_FILE_OFFSET_BITS=64")


def compiler() -> Optional[str]:
    """The C++ compiler (``$CXX``, default ``g++``) on PATH, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvitio_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile ``native/vitio.cpp`` unless a library of this source exists;
    -> its path, or None without a compiler or a source.  A failed
    compile raises."""
    cxx = compiler()
    if cxx is None or not SOURCE.is_file():
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this process's and thread's own: concurrent builds never
    # write one file
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native reader failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.vitio_file_size.restype = ctypes.c_longlong
    lib.vitio_file_size.argtypes = [ctypes.c_char_p]
    lib.vitio_read_fp32.restype = ctypes.c_longlong
    lib.vitio_read_fp32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
    ]
    lib.vitio_read_image_bin_header.restype = ctypes.c_int
    lib.vitio_read_image_bin_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.vitio_read_image_bin_data.restype = ctypes.c_longlong
    lib.vitio_read_image_bin_data.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    lib.vitio_gather_read.restype = ctypes.c_longlong
    lib.vitio_gather_read.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int,
    ]
    return lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:  # not assert: must survive python -O
        raise RuntimeError(
            "native reader not available: no C++ compiler ($CXX or g++) or no native/vitio.cpp"
        )
    return lib


def available() -> bool:
    return _load() is not None


def gather_available() -> bool:
    # the port builds the current source, which always has the gather reader
    return available()


def gather_read(
    paths,
    sample_path: np.ndarray,
    sample_offset: np.ndarray,
    sample_bytes: int,
    threads: int = 8,
) -> np.ndarray:
    """Parallel gather of equal-size records scattered across ``paths``:
    record i comes from ``paths[sample_path[i]]`` at byte ``sample_offset[i]``.
    Returns a flat uint8 array of ``len(sample_path) * sample_bytes`` — the
    threaded hot path of ``io/dataset.BinShardDataset.read``."""
    lib = _require()
    sample_path = np.ascontiguousarray(sample_path, dtype=np.int32)
    sample_offset = np.ascontiguousarray(sample_offset, dtype=np.int64)
    n = len(sample_path)
    if len(sample_offset) != n:
        raise ValueError("sample_path and sample_offset length mismatch")
    # the C workers index paths[sample_path[i]] unchecked: a stale index
    # must fail here as an exception, not as an out-of-bounds read
    if n and (sample_path.min() < 0 or sample_path.max() >= len(paths)):
        raise ValueError(
            f"sample_path indexes outside paths[0:{len(paths)}] "
            f"(min {sample_path.min()}, max {sample_path.max()}) — "
            "corrupted or stale dataset index?"
        )
    encoded = [str(p).encode() for p in paths]
    c_paths = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty(n * sample_bytes, dtype=np.uint8)
    got = lib.vitio_gather_read(
        c_paths,
        sample_path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sample_offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        sample_bytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        max(1, int(threads)),
    )
    if got != n:
        raise ValueError(f"gather read: {got}/{n} samples read")
    return out


def read_fp32(path, round_to_6dp: bool = True) -> np.ndarray:
    """A whole file of little-endian fp32, optionally with the reference's
    6-decimal rounding (Network.c:184-187) applied in C++."""
    lib = _require()
    cpath = str(path).encode()
    nbytes = lib.vitio_file_size(cpath)
    if nbytes < 0:
        raise FileNotFoundError(path)
    count = nbytes // 4
    out = np.empty(count, dtype=np.float32)
    got = lib.vitio_read_fp32(
        cpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count,
        1 if round_to_6dp else 0,
    )
    if got != count:
        raise ValueError(f"{path}: short read ({got}/{count} floats)")
    return out


def read_image_bin(path) -> np.ndarray:
    """The input-100.bin format -> (N, C, H, W) float32."""
    lib = _require()
    if not os.path.exists(path):  # the C side returns the same -1 for
        raise FileNotFoundError(path)  # fopen failure and short reads
    cpath = str(path).encode()
    header = (ctypes.c_int * 4)()
    if lib.vitio_read_image_bin_header(cpath, header) != 0:
        raise ValueError(f"{path}: truncated header (Network.c:36-44 format)")
    n, c, h, w = header[0], header[1], header[2], header[3]
    if min(n, c, h, w) < 0:
        raise ValueError(f"{path}: negative header field ({n}, {c}, {h}, {w})")
    out = np.empty(n * c * h * w, dtype=np.float32)
    got = lib.vitio_read_image_bin_data(
        cpath, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
    )
    if got != out.size:
        raise ValueError(f"{path}: expected {out.size} fp32 values, got {got}")
    return out.reshape(n, c, h, w)
