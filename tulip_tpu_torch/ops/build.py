"""Build and load the CUDA kernels of ``tulip_tpu_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/tulip_tpu_torch/`` under the repository root, named
by a hash of the sources and flags, so an edited source is rebuilt on first
use and an unchanged one is loaded as it is.

There is no fallback: if ``nvcc`` is missing or the build fails,
:func:`load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tulip_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: every one returns cudaGetLastError() after its launch
SIGNATURES = {
    # dtype, x, out, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, y,
    # partial, B, H, W, C, nh, wh, ww, sh, sw, scale, eps, hs, splits,
    # stages, smem, stream
    "tulip_window_msa": ([_I] + [_P] * 12 + [_I] * 9 + [_F, _F] + [_I] * 4
                         + [_P]),
    # dtype, xg, out, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, y,
    # partial, windows, nW, C, nh, scale, eps, hs, splits, stages, smem,
    # stream
    "tulip_window_msa_grouped": ([_I] + [_P] * 12 + [_I] * 4 + [_F, _F]
                                 + [_I] * 4 + [_P]),
    # dtype, act, x, out, lnw, lnb, w1, b1, w2, b2, y, partial,
    # N, C, Hd, O, residual, eps, hs, splits, resident, bn2, smem, stream
    "tulip_two_matmul": ([_I, _I] + [_P] * 10 + [_I] * 5 + [_F] + [_I] * 5
                         + [_P]),
    # dtype, x, out, lnw, lnb, w, y, partial, N, K, O, eps, bn, splits,
    # smem, stream
    "tulip_ln_linear": [_I] + [_P] * 7 + [_I] * 3 + [_F] + [_I] * 3 + [_P],
    # a, b, out, N, M, chunk, stream
    "tulip_nn_brute": [_P] * 3 + [_I] * 3 + [_P],
    # a, b, partial, codes, N, M, stream
    "tulip_nn_h2_codes": [_P] * 4 + [_I] * 2 + [_P],
    # a, b, perm, a_s, b_s, boxes, N, M, stream
    "tulip_nn_h2_gather": [_P] * 6 + [_I] * 2 + [_P],
    # a_s, b_s, boxes, perm, thr, wmax, smin, sa, sb, counts, done, list,
    # out_a, out_b, N, M, stream
    "tulip_nn_h2": [_P] * 14 + [_I] * 2 + [_P],
    # a_s, b_s, boxes, perm, thr, smin, sa, counts, done, list, out, N, M,
    # stream
    "tulip_nn_h1": [_P] * 11 + [_I] * 2 + [_P],
    # dtype, qkv, out, bias, mask, B, H, W, C, nh, wh, ww, sh, sw, ctas, hg,
    # smem, scale, stream
    "tulip_attn_fwd": [_I] + [_P] * 4 + [_I] * 12 + [_F, _P],
    # dtype, qkv, dout, dqkv, bias, mask, part, B, H, W, C, nh, wh, ww, sh,
    # sw, nsplit (bf16: ctas), hg, smem, scale, stream
    "tulip_attn_bwd": [_I] + [_P] * 6 + [_I] * 12 + [_F, _P],
    # dtype, act, x, g, lnw, lnb, w1, b1, w2, dx, y, a, dh, part, stat, dyp,
    # N, C, Hd, O, residual, eps, dy_splits, stream
    "tulip_two_matmul_bwd": [_I, _I] + [_P] * 14 + [_I] * 5 + [_F, _I, _P],
    # dtype, x, g, lnw, lnb, w, dx, y, part, stat, dyp, N, K, O, eps,
    # dy_splits, stream
    "tulip_ln_linear_bwd": [_I] + [_P] * 10 + [_I] * 3 + [_F, _I, _P],
    # dtype, x, w, b, y, N, C, lanes, rows per CTA, ctas, eps, stream
    "tulip_ln_fwd": [_I] + [_P] * 4 + [_L, _I, _I, _L, _I, _F, _P],
    # dtype, x, w, g, dx, part, gpart, tickets, dwdb, N, C, lanes, rows per
    # CTA, ctas, CTAs per group, eps, stream
    "tulip_ln_bwd": [_I] + [_P] * 8 + [_L, _I, _I, _L, _I, _I, _F, _P],
    # dtype, in, out, scratch, R, M, stream
    "tulip_colsum": [_I] + [_P] * 3 + [_L, _I, _P],
    # dtype, A, B, part, T, M, N, tokens per split, stream
    "tulip_tn_gemm": [_I] + [_P] * 3 + [_L, _I, _I, _L, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc run of this process, if any
build_log = ""         # nvcc's output of that run (-Xptxas -v resource use)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    searched = []
    home = os.environ.get("CUDA_HOME")
    if home:
        searched.append(os.path.join(home, "bin", "nvcc"))
    searched.append("/usr/local/cuda/bin/nvcc")
    for cand in searched:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found; searched " + ", ".join(searched)
                       + " and PATH")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtulip_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """One nvcc per source, all running at once, then one link."""
    global build_seconds, build_log
    nvcc = find_nvcc()
    cu, _ = _sources()
    obj_dir = out.with_suffix(f".{os.getpid()}.obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{f.stem}.o" for f in cu]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for f, o in zip(cu, objs)]
    logs = [f"== {f.name}\n{p.communicate()[0]}" for f, p in zip(cu, procs)]
    failed = [f.name for f, p in zip(cu, procs) if p.returncode != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raise on failure."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tulip_error_string.argtypes = [ctypes.c_int]
            lib.tulip_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.tulip_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def require(t, name: str, device, dtype, shape) -> None:
    """Validate one kernel operand before its pointer is passed to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(name: str, t, nbytes: int = 16) -> None:
    """Raise unless t (or None) starts on an nbytes boundary: the
    tensor-core kernels read their operands with 16-byte copies."""
    if t is not None and t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary "
                         f"(storage offset {t.storage_offset()})")


def not_cuda(x) -> ValueError:
    return ValueError(f"kernels run on cuda tensors (plain version on cpu); "
                      f"got a tensor on {x.device}")
