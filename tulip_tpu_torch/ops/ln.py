"""LayerNorm over the last axis of (N, C) tokens, forward and backward.

Replaces the Pallas kernels tulip_tpu/ops/pallas/ln.py ``_fwd_kernel`` and
``_bwd_kernel`` (``layer_norm_vjp``) with ``csrc/ln.cu``.  :func:`ln_fwd`
and :func:`ln_bwd` take the plain PyTorch versions for CPU tensors and
launch the kernels for CUDA tensors; any other device raises.
:func:`layer_norm_fn` is the differentiable entry: it saves x and w only,
and its backward recomputes the row statistics.

w and b are read as fp32 whatever the activation dtype (the train step
keeps fp32 master weights); dw and db are summed in fp32 and returned in
the parameters' dtype.
"""

from __future__ import annotations

import torch

from . import build
from .reduce import colsum
from ..models.layers import layer_norm, wide

_WARPS = 8             # csrc/ln.cu kLnWarps: rows in flight per block
_TARGET_BLOCKS = 1024  # partial (2, C) sums that the backward writes, at most


def layer_norm_ref(x2d, w, b, eps: float = 1e-6):
    """Plain PyTorch LayerNorm: fp32 statistics and affine, cast back."""
    return layer_norm(x2d, w, b, eps)


def layer_norm_bwd_ref(x2d, w, g, eps: float = 1e-6):
    """Plain PyTorch backward: (dx in x's dtype, dw fp32, db fp32), the
    closed form of ln.py:53-69 in fp32."""
    x32, g32 = wide(x2d), wide(g)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xh = (x32 - mean) * rstd
    t = g32 * w.to(x32.dtype)
    m1 = t.mean(-1, keepdim=True)
    m2 = (t * xh).mean(-1, keepdim=True)
    dx = (rstd * (t - m1 - xh * m2)).to(x2d.dtype)
    return dx, (g32 * xh).sum(0), g32.sum(0)


def _check(x2d, w, what):
    if x2d.ndim != 2:
        raise ValueError(f"{what} takes (N, C) tokens, got {tuple(x2d.shape)}")
    N, C = x2d.shape
    build.require(x2d, "x", x2d.device, x2d.dtype, (N, C))
    build.dtype_code(x2d)
    if tuple(w.shape) != (C,):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {(C,)}")
    return N, C


def _f32(t, name, device, C):
    t = t.float().contiguous()
    build.require(t, name, device, torch.float32, (C,))
    return t


def ln_fwd(x2d, w, b, eps: float = 1e-6):
    """LayerNorm of x2d (N, C) with affine w, b (C,)."""
    if x2d.device.type == "cpu":
        return layer_norm_ref(x2d, w, b, eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, C = _check(x2d, w, "ln_fwd")
    dev = x2d.device
    wf, bf = _f32(w, "w", dev, C), _f32(b, "b", dev, C)
    lib = build.load()
    y = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = lib.tulip_ln_fwd(
            build.dtype_code(x2d), x2d.data_ptr(), wf.data_ptr(),
            bf.data_ptr(), y.data_ptr(), N, C, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ln_fwd")
    ln_fwd.launches += 1
    return y


ln_fwd.launches = 0


def ln_bwd(x2d, w, g, eps: float = 1e-6):
    """(dx, dw, db) of :func:`ln_fwd` at upstream gradient g (N, C) in x's
    dtype; dw and db are fp32."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_ref(x2d, w, g, eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, C = _check(x2d, w, "ln_bwd")
    dev = x2d.device
    build.require(g, "g", dev, x2d.dtype, (N, C))
    wf = _f32(w, "w", dev, C)
    rows = -(-N // _TARGET_BLOCKS)
    rows = max(_WARPS, -(-rows // _WARPS) * _WARPS)
    blocks = -(-N // rows)
    dx = torch.empty_like(x2d)
    part = torch.empty((blocks, 2 * C), device=dev, dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.tulip_ln_bwd(
            build.dtype_code(x2d), x2d.data_ptr(), wf.data_ptr(),
            g.data_ptr(), dx.data_ptr(), part.data_ptr(), N, C, rows,
            float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ln_bwd")
    ln_bwd.launches += 1
    sums = colsum(part)
    return dx, sums[:C], sums[C:]


ln_bwd.launches = 0


class LayerNormFn(torch.autograd.Function):
    """LayerNorm whose forward and backward are the kernels above."""

    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        ctx.b_dtype = b.dtype
        return ln_fwd(x2d, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        dx, dw, db = ln_bwd(x2d, w, g.to(x2d.dtype).contiguous(), ctx.eps)
        return dx, dw.to(w.dtype), db.to(ctx.b_dtype), None


def layer_norm_fn(x2d, w, b, eps: float = 1e-6):
    """Differentiable LayerNorm over the last axis of (N, C) tokens."""
    return LayerNormFn.apply(x2d, w, b, eps)
