"""The cross-block reductions of the backward kernels (``csrc/reduce.cu``).

Called only from the CUDA paths of :mod:`.attn_core` and :mod:`.mlp`, with
CUDA tensors: the weight- and bias-gradient sums that the TPU kernels
accumulated across their in-order grid.  Both run in a fixed order
(deterministic) and return fp32.
"""

from __future__ import annotations

import torch

from . import build

_COL_BLOCK_ROWS = 256      # csrc/reduce.cu kColBlockRows
# blocks tn_gemm aims for: bf16 two per SM of 132 (two blocks share an SM;
# fewer, longer splits: less fp32 partial output to write and to sum);
# fp32 eight per SM (three blocks share an SM: mma.cuh kF32Ctas): the
# fp32 batch-8 step's weight gradients took 9.41 ms of device time on an
# NVIDIA H100 80GB HBM3 at 700 W, against 10.26 at 396 and 10.85 at 264
# (PERF.md)
_TARGET_BLOCKS = {torch.float32: 1056, torch.bfloat16: 264}
# csrc/reduce.cu: tokens per slice of the split-TF32 kernel (64 x 64
# output tiles) and of the bf16 tensor-core kernel (64 x 192 tiles where
# 192 divides N, else 64 x 128)
_SLICE = {torch.float32: 32, torch.bfloat16: 64}


def mn_tile(n: int) -> int:
    """Output columns per CTA of the bf16 products that tile their output
    columns over the grid (csrc/mlp.cu ln_linear, csrc/mlp_bwd.cu dy,
    csrc/reduce.cu tn_gemm): 192 where that divides n, else 128."""
    return 192 if n % 192 == 0 else 128


def tn_gemm_plan(T: int, M: int, N: int, dtype) -> tuple[int, int]:
    """(splits, tokens per split) of :func:`tn_gemm`: about
    ``_TARGET_BLOCKS[dtype]`` blocks, at least 256 tokens per split, every
    token in exactly one split, tokens per split a multiple of the
    kernel's slice."""
    bn = mn_tile(N) if dtype == torch.bfloat16 else 64
    tiles = -(-M // 64) * -(-N // bn)
    splits = max(1, min(-(-_TARGET_BLOCKS[dtype] // tiles), -(-T // 256)))
    slice_ = _SLICE[dtype]
    tps = -(-(-(-T // splits)) // slice_) * slice_
    return -(-T // tps), tps


def colsum(t: torch.Tensor) -> torch.Tensor:
    """Column sums of a contiguous (R, M) fp32 / bf16 CUDA tensor, fp32."""
    R, M = t.shape
    build.require(t, "colsum input", t.device, t.dtype, (R, M))
    out = torch.empty(M, device=t.device, dtype=torch.float32)
    scratch = None
    if R > 2 * _COL_BLOCK_ROWS:
        S = -(-R // _COL_BLOCK_ROWS)
        scratch = torch.empty((S, M), device=t.device, dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(t.device):
        err = lib.tulip_colsum(
            build.dtype_code(t), t.data_ptr(), out.data_ptr(),
            build.ptr(scratch), R, M,
            torch.cuda.current_stream(t.device).cuda_stream)
    build.check(lib, err, "colsum")
    colsum.launches += 1 if scratch is None else 2
    return out


colsum.launches = 0   # kernels launched: two where the rows exceed 512


def tn_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.T @ b over the token axis, fp32: a (T, M), b (T, N) -> (M, N),
    bf16 or fp32 (split TF32) on the tensor cores.  The token axis is
    split (:func:`tn_gemm_plan`); the splits' partials are summed by
    :func:`colsum` in split order."""
    T, M = a.shape
    N = b.shape[1]
    build.require(b, "tn_gemm b", a.device, a.dtype, (T, N))
    if M % 8 or N % 8:
        raise NotImplementedError(
            f"tn_gemm takes M, N multiples of 8; got M={M}, N={N}")
    build.require_aligned("tn_gemm a", a)
    build.require_aligned("tn_gemm b", b)
    splits, tps = tn_gemm_plan(T, M, N, a.dtype)
    part = torch.empty((splits, M, N), device=a.device, dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(a.device):
        err = lib.tulip_tn_gemm(
            build.dtype_code(a), a.data_ptr(), b.data_ptr(), part.data_ptr(),
            T, M, N, tps, torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "tn_gemm")
    if splits == 1:
        return part[0]
    return colsum(part.view(splits, M * N)).view(M, N)
