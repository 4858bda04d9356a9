"""The fused host reader of the port's data path (``data/native/loader.cpp``).

One C call reads channel 0 of a float32 ``.npy`` range map and applies a
dataset builder's transform chain in the same pass (scale, range gate, row
and column strides, log1p); :func:`read_range_batch` reads a whole batch
over a pthread pool, outside the interpreter lock.  This is host I/O: g++
builds it, and it runs on the CPU whatever device the model is on.

The port's copy of ``tulip_tpu/data/native.py``, with the same C interface
and arithmetic, and three differences:

- the library is built on first use into ``build/tulip_tpu_torch/`` under
  the repository root, named by a hash of the source and the flags, and
  written under a temporary name that is then moved into place, so that
  processes building at once never load a half-written file;
- nothing falls back: a failed build raises with g++'s output, a failed
  read raises and names the file.  Which folders read natively is decided
  up front, from a file's header (:func:`native_shape`,
  ``data/datasets.py:RangeMapFolder``), never by catching a failure;
- :data:`counts` tallies the batches and items read here and the items the
  numpy chain read (``data/datasets.py``), so that a run can show which
  path its data took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tulip_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None

# batches and items read natively, and items read by the numpy chain
counts = {"batches": 0, "items": 0, "numpy_items": 0}
_count_lock = threading.Lock()


def count(key: str, n: int = 1) -> None:
    with _count_lock:
        counts[key] += n


def reset_counts() -> None:
    with _count_lock:
        for k in counts:
            counts[k] = 0


def library_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libtulip_io_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"the native reader's build could not start "
                           f"{CXX!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native reader's build failed ({' '.join(cmd)}, exit "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the reader; raise on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            lib.tulip_read_npy_range.restype = ctypes.c_int
            lib.tulip_read_npy_range.argtypes = [
                ctypes.c_char_p, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_float)]
            lib.tulip_npy_shape.restype = ctypes.c_int
            lib.tulip_npy_shape.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
            lib.tulip_read_npy_batch.restype = ctypes.c_int
            lib.tulip_read_npy_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _lib = lib
        return _lib


def _unreadable(path: str) -> OSError:
    return OSError(f"the native reader could not read {path}: missing, "
                   f"truncated, not a C-order float32 .npy of 2 or 3 dims, "
                   f"or smaller than the output asked of it")


def native_shape(path: str) -> Optional[Tuple[int, int, int]]:
    """(h, w, c) of a .npy file of the kind loader.cpp reads (a v1 / v2
    header, little-endian float32, C order, 2 or 3 dims; c = 1 for 2
    dims), else None.  Reads the header in Python: builds nothing."""
    with open(path, "rb") as f:
        if f.read(6) != b"\x93NUMPY":
            return None
        f.seek(0)
        major, _ = np.lib.format.read_magic(f)
        if major not in (1, 2):
            return None
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
    if dtype != np.dtype("<f4") or fortran or len(shape) not in (2, 3):
        return None
    return int(shape[0]), int(shape[1]), int(shape[2]) if len(shape) == 3 else 1


def output_shape(h: int, w: int, row_start: int = 0, row_stride: int = 0,
                 col_stride: int = 0) -> Tuple[int, int]:
    """(rows, cols) the fused chain makes of an (h, w) map."""
    oh = h if row_stride <= 0 else (h - row_start + row_stride - 1) // row_stride
    ow = w if col_stride <= 1 else (w + col_stride - 1) // col_stride
    return oh, ow


def npy_shape(path: str) -> Tuple[int, int, int]:
    """(h, w, c) from the C header parser; raises if it cannot read it."""
    lib = load()
    h, w, c = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    if lib.tulip_npy_shape(os.fsencode(path), ctypes.byref(h),
                           ctypes.byref(w), ctypes.byref(c)) != 0:
        raise _unreadable(path)
    return int(h.value), int(w.value), int(c.value)


def read_range_map(path: str, *, scale: float = 1.0, min_r: float = -1.0,
                   max_r: float = 1.0, log1p: bool = False,
                   row_start: int = 0, row_stride: int = 0,
                   col_stride: int = 0, out_shape=None) -> np.ndarray:
    """Channel 0 of one map through the fused chain, (rows, cols) float32;
    the gate applies where min_r >= 0.  out_shape defaults to the file's
    own (:func:`output_shape` of its header)."""
    lib = load()
    if out_shape is None:
        h, w, _ = npy_shape(path)
        out_shape = output_shape(h, w, row_start, row_stride, col_stride)
    oh, ow = out_shape
    out = np.empty((oh, ow), np.float32)
    rc = lib.tulip_read_npy_range(
        os.fsencode(path), scale, min_r, max_r, int(log1p), row_start,
        row_stride, col_stride, oh, ow,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise _unreadable(path)
    count("items")
    return out


def read_range_batch(paths: Sequence[str], *, out_shape,
                     scale: float = 1.0, min_r: float = -1.0,
                     max_r: float = 1.0, log1p: bool = False,
                     row_start: int = 0, row_stride: int = 0,
                     col_stride: int = 0,
                     num_threads: int = 8) -> np.ndarray:
    """(B, 1, rows, cols) float32 through the pthread pool, each map as
    :func:`read_range_map` reads it; raises naming every file that failed."""
    lib = load()
    num_threads = max(1, min(num_threads, os.cpu_count() or 1))
    oh, ow = out_shape
    n = len(paths)
    out = np.empty((n, 1, oh, ow), np.float32)
    encoded = [os.fsencode(p) for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    failed = lib.tulip_read_npy_batch(
        arr, n, scale, min_r, max_r, int(log1p), row_start, row_stride,
        col_stride, oh, ow,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if failed:
        one = np.empty((oh, ow), np.float32)
        bad = [p for p, e in zip(paths, encoded) if lib.tulip_read_npy_range(
            e, scale, min_r, max_r, int(log1p), row_start, row_stride,
            col_stride, oh, ow,
            one.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0]
        raise _unreadable(", ".join(bad) if bad else
                          f"{failed} of the batch's {n} files")
    count("batches")
    count("items", n)
    return out
