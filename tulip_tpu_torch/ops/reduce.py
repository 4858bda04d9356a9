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
_TARGET_BLOCKS = 1056      # eight waves of 132 SMs


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
    return out


def tn_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.T @ b over the token axis, fp32: a (T, M), b (T, N) -> (M, N).
    The token axis is split so that about eight waves of blocks run; the
    splits' partials are summed by :func:`colsum`."""
    T, M = a.shape
    N = b.shape[1]
    build.require(b, "tn_gemm b", a.device, a.dtype, (T, N))
    tiles = -(-M // 64) * -(-N // 64)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-T // 256)))
    tps = -(-T // splits)
    tps = -(-tps // 16) * 16
    splits = -(-T // tps)
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
