"""Fused [LayerNorm ->] matmul -> activation -> matmul [-> residual], and
LayerNorm -> matmul, forward and backward.

Replaces the Pallas kernels of tulip_tpu/ops/pallas/mlp.py: ``_kernel``
(K3, :func:`fused_two_matmul`: the Swin MLP half-block and the folded
norm_up + ps_head + decoder_pred head) and ``_kernel_ln_mm`` (K4,
:func:`fused_ln_linear`: the patch-merging LN + reduction) with the CUDA
kernels of ``csrc/mlp.cu``; their backwards ``_bwd_kernel`` (K10,
:func:`two_matmul_bwd`) and ``_kernel_ln_mm_bwd`` (K11,
:func:`ln_linear_bwd`) with ``csrc/mlp_bwd.cu`` plus the weight-gradient
reductions of ``csrc/reduce.cu``.  :class:`TwoMatmul` and :class:`LnLinear`
join each pair as a ``torch.autograd.Function`` (the training path).

Each wrapper takes its plain PyTorch version (``*_ref``) for a CPU tensor
and launches its kernels for a CUDA tensor; any other device raises.
"""

from __future__ import annotations

import torch

from . import build
from .reduce import colsum, tn_gemm
from ..models.layers import gelu, layer_norm, leaky_relu, linear, wide

ACTS = {"gelu": 0, "leaky": 1}


def fused_two_matmul_ref(x2d, lnw, lnb, w1, b1, w2, b2, *, act: str,
                         residual: bool, eps: float = 1e-6):
    """Plain version: x2d (N, C); w1 (Hd, C), w2 (O, Hd) in torch layout;
    lnw None skips the LayerNorm, b2 None means no second bias.  The LN
    output and the activation are rounded to the input dtype, as in the
    kernel; GELU is the exact erf form in fp32."""
    y = x2d if lnw is None else layer_norm(x2d, lnw, lnb, eps)
    h = linear(y, w1, b1)
    h = gelu(h) if act == "gelu" else leaky_relu(h)
    o = wide(linear(h, w2, b2))
    if residual:
        o = o + wide(x2d)
    return o.to(x2d.dtype)


def fused_two_matmul(x2d, lnw, lnb, w1, b1, w2, b2, *, act: str,
                     residual: bool, eps: float = 1e-6):
    """[LN ->] x @ w1.T + b1 -> act -> @ w2.T [+ b2] [+ x]; the (N, Hd)
    hidden never leaves the kernel.  Arguments as in the plain version."""
    if x2d.device.type == "cpu":
        return fused_two_matmul_ref(x2d, lnw, lnb, w1, b1, w2, b2, act=act,
                                    residual=residual, eps=eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    N, C = x2d.shape
    Hd, O = w1.shape[0], w2.shape[0]
    if C % 32 or Hd % 32 or (residual and O != C):
        raise NotImplementedError(
            f"two_matmul kernel takes C, Hd multiples of 32 and O == C with "
            f"residual; got C={C}, Hd={Hd}, O={O}, residual={residual}")
    dev, d = x2d.device, x2d.dtype
    build.require(x2d, "x", dev, d, (N, C))
    build.require(w1, "w1", dev, d, (Hd, C))
    build.require(b1, "b1", dev, d, (Hd,))
    build.require(w2, "w2", dev, d, (O, Hd))
    if b2 is not None:
        build.require(b2, "b2", dev, d, (O,))
    if lnw is not None:
        build.require(lnw, "lnw", dev, d, (C,))
        build.require(lnb, "lnb", dev, d, (C,))
    lib = build.load()
    out = torch.empty((N, O), device=dev, dtype=d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_two_matmul(
            build.dtype_code(x2d), ACTS[act], x2d.data_ptr(), out.data_ptr(),
            build.ptr(lnw), build.ptr(lnb), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), build.ptr(b2), N, C, Hd, O, int(residual),
            float(eps), stream)
    build.check(lib, err, "two_matmul")
    fused_two_matmul.launches += 1
    return out


fused_two_matmul.launches = 0


def fused_ln_mlp(x2d, lnw, lnb, w1, b1, w2, b2, *, eps: float = 1e-6):
    """Swin MLP half-block: x + fc2(gelu(fc1(LN(x))))."""
    return fused_two_matmul(x2d, lnw, lnb, w1, b1, w2, b2, act="gelu",
                            residual=True, eps=eps)


def fused_ln_linear_ref(x2d, lnw, lnb, w, *, eps: float = 1e-6):
    """Plain version: LN(x) @ w.T, bias-free; w (O, K) in torch layout."""
    return linear(layer_norm(x2d, lnw, lnb, eps), w)


def fused_ln_linear(x2d, lnw, lnb, w, *, eps: float = 1e-6):
    """LN(x) @ w.T (the patch-merging norm + reduction)."""
    if x2d.device.type == "cpu":
        return fused_ln_linear_ref(x2d, lnw, lnb, w, eps=eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, K = x2d.shape
    O = w.shape[0]
    if K % 32:
        raise NotImplementedError(f"ln_linear kernel takes K % 32 == 0, "
                                  f"got K={K}")
    dev, d = x2d.device, x2d.dtype
    build.require(x2d, "x", dev, d, (N, K))
    build.require(lnw, "lnw", dev, d, (K,))
    build.require(lnb, "lnb", dev, d, (K,))
    build.require(w, "w", dev, d, (O, K))
    lib = build.load()
    out = torch.empty((N, O), device=dev, dtype=d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_ln_linear(
            build.dtype_code(x2d), x2d.data_ptr(), out.data_ptr(),
            lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), N, K, O,
            float(eps), stream)
    build.check(lib, err, "ln_linear")
    fused_ln_linear.launches += 1
    return out


fused_ln_linear.launches = 0


# ---------------------------------------------------------------------------
# Backward (training path)
# ---------------------------------------------------------------------------

def _ln_stats(x2d, eps):
    """(xh, rstd) of the LayerNorm over the last axis, in the wide dtype."""
    x = wide(x2d)
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    return (x - mean) * rstd, rstd


def _ln_backward(dy, xh, rstd, lnw):
    """(dx, dlnw, dlnb) of y = xh * lnw + lnb, xh = LN(x), from dy (wide)."""
    dxh = dy * wide(lnw)
    dx = rstd * (dxh - dxh.mean(-1, keepdim=True)
                 - xh * (dxh * xh).mean(-1, keepdim=True))
    return dx, (dy * xh).sum(0), dy.sum(0)


def _act_grad(h, act: str):
    """d act / dh at h (wide): exact erf GELU, or leaky with slope 1 at 0."""
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
        return cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327
    return torch.where(h >= 0, torch.ones_like(h), torch.full_like(h, 0.01))


def two_matmul_bwd_ref(x2d, lnw, lnb, w1, b1, w2, b2, g, *, act: str,
                       residual: bool, eps: float = 1e-6):
    """Plain backward of :func:`fused_two_matmul_ref`, written out: from
    g = dL/dout (N, O) -> (dx, dlnw, dlnb, dw1, db1, dw2, db2), each in its
    input's dtype (None where the input is None).  Recomputes y and h; y, h,
    a and dh are rounded to x's dtype at the kernel's points, everything
    else accumulates in fp32 (float64 for float64 inputs)."""
    d = x2d.dtype
    y = x2d if lnw is None else layer_norm(x2d, lnw, lnb, eps)
    h = linear(y, w1, b1)
    a = gelu(h) if act == "gelu" else leaky_relu(h)
    gw = wide(g)
    dh = (gw @ wide(w2) * _act_grad(wide(h), act)).to(d)
    dw2 = gw.T @ wide(a)
    dy = wide(dh) @ wide(w1)
    dw1 = wide(dh).T @ wide(y)
    dlnw = dlnb = None
    if lnw is None:
        dx = dy
    else:
        xh, rstd = _ln_stats(x2d, eps)
        dx, dlnw, dlnb = _ln_backward(dy, xh, rstd, lnw)
    if residual:
        dx = dx + gw
    cast = lambda t, like: None if like is None else t.to(like.dtype)
    return (dx.to(d), cast(dlnw, lnw), cast(dlnb, lnb), cast(dw1, w1),
            cast(wide(dh).sum(0), b1), cast(dw2, w2), cast(gw.sum(0), b2))


def two_matmul_bwd(x2d, lnw, lnb, w1, b1, w2, b2, g, *, act: str,
                   residual: bool, eps: float = 1e-6):
    """Backward of :func:`fused_two_matmul` (K10).  CUDA: the token pass
    (recompute, da, dh, dy, dx; scratch y, a, dh) then the weight-gradient
    products and column sums of ``csrc/reduce.cu``.  Outputs as in
    :func:`two_matmul_bwd_ref`."""
    if x2d.device.type == "cpu":
        return two_matmul_bwd_ref(x2d, lnw, lnb, w1, b1, w2, b2, g, act=act,
                                  residual=residual, eps=eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    N, C = x2d.shape
    Hd, O = w1.shape[0], w2.shape[0]
    if C % 32 or Hd % 32 or (residual and O != C):
        raise NotImplementedError(
            f"two_matmul backward takes C, Hd multiples of 32 and O == C "
            f"with residual; got C={C}, Hd={Hd}, O={O}, residual={residual}")
    dev, d = x2d.device, x2d.dtype
    build.require(x2d, "x", dev, d, (N, C))
    build.require(g, "g", dev, d, (N, O))
    build.require(w1, "w1", dev, d, (Hd, C))
    build.require(b1, "b1", dev, d, (Hd,))
    build.require(w2, "w2", dev, d, (O, Hd))
    if lnw is not None:
        build.require(lnw, "lnw", dev, d, (C,))
        build.require(lnb, "lnb", dev, d, (C,))
    empty = lambda *shape, dt=d: torch.empty(shape, device=dev, dtype=dt)
    dx, a, dh = empty(N, C), empty(N, Hd), empty(N, Hd)
    y = part = None
    if lnw is not None:
        y = empty(N, C)
        part = empty(-(-N // 16), 2 * C, dt=torch.float32)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_two_matmul_bwd(
            build.dtype_code(x2d), ACTS[act], x2d.data_ptr(), g.data_ptr(),
            build.ptr(lnw), build.ptr(lnb), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), build.ptr(y), a.data_ptr(),
            dh.data_ptr(), build.ptr(part), N, C, Hd, O, int(residual),
            float(eps), stream)
    build.check(lib, err, "two_matmul_bwd")
    dlnw = dlnb = None
    if lnw is not None:
        dln = colsum(part).to(d)
        dlnw, dlnb = dln[:C], dln[C:]
    out = (dx, dlnw, dlnb, tn_gemm(dh, x2d if y is None else y).to(d),
           colsum(dh).to(d), tn_gemm(g, a).to(d),
           None if b2 is None else colsum(g).to(d))
    two_matmul_bwd.launches += 1
    return out


two_matmul_bwd.launches = 0


def ln_linear_bwd_ref(x2d, lnw, lnb, w, g, *, eps: float = 1e-6):
    """Plain backward of :func:`fused_ln_linear_ref`, written out: from
    g (N, O) -> (dx, dlnw, dlnb, dw) in the inputs' dtypes."""
    y = layer_norm(x2d, lnw, lnb, eps)
    gw = wide(g)
    dy = gw @ wide(w)
    xh, rstd = _ln_stats(x2d, eps)
    dx, dlnw, dlnb = _ln_backward(dy, xh, rstd, lnw)
    return (dx.to(x2d.dtype), dlnw.to(lnw.dtype), dlnb.to(lnb.dtype),
            (gw.T @ wide(y)).to(w.dtype))


def ln_linear_bwd(x2d, lnw, lnb, w, g, *, eps: float = 1e-6):
    """Backward of :func:`fused_ln_linear` (K11): the token pass (dy = g W,
    LN backward, scratch y) then dW = g^T y and the LN column sums."""
    if x2d.device.type == "cpu":
        return ln_linear_bwd_ref(x2d, lnw, lnb, w, g, eps=eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, K = x2d.shape
    O = w.shape[0]
    if K % 32:
        raise NotImplementedError(f"ln_linear backward takes K % 32 == 0, "
                                  f"got K={K}")
    dev, d = x2d.device, x2d.dtype
    build.require(x2d, "x", dev, d, (N, K))
    build.require(g, "g", dev, d, (N, O))
    build.require(lnw, "lnw", dev, d, (K,))
    build.require(lnb, "lnb", dev, d, (K,))
    build.require(w, "w", dev, d, (O, K))
    dx = torch.empty_like(x2d)
    y = torch.empty_like(x2d)
    part = torch.empty((-(-N // 16), 2 * K), device=dev, dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_ln_linear_bwd(
            build.dtype_code(x2d), x2d.data_ptr(), g.data_ptr(),
            lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), dx.data_ptr(),
            y.data_ptr(), part.data_ptr(), N, K, O, float(eps), stream)
    build.check(lib, err, "ln_linear_bwd")
    dln = colsum(part).to(d)
    out = (dx, dln[:K], dln[K:], tn_gemm(g, y).to(d))
    ln_linear_bwd.launches += 1
    return out


ln_linear_bwd.launches = 0


class TwoMatmul(torch.autograd.Function):
    """:func:`fused_two_matmul` (K3) with :func:`two_matmul_bwd` (K10) as
    its backward; the (N, Hd) hidden is recomputed, never saved."""

    @staticmethod
    def forward(ctx, x2d, lnw, lnb, w1, b1, w2, b2, act, residual, eps):
        ctx.save_for_backward(x2d, lnw, lnb, w1, b1, w2, b2)
        ctx.opts = dict(act=act, residual=residual, eps=eps)
        return fused_two_matmul(x2d, lnw, lnb, w1, b1, w2, b2, act=act,
                                residual=residual, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = two_matmul_bwd(*ctx.saved_tensors, g.contiguous(), **ctx.opts)
        return (*grads, None, None, None)


def two_matmul(x2d, lnw, lnb, w1, b1, w2, b2, *, act: str, residual: bool,
               eps: float = 1e-6):
    """Differentiable :func:`fused_two_matmul` (arguments as there)."""
    return TwoMatmul.apply(x2d, lnw, lnb, w1, b1, w2, b2, act, residual, eps)


class LnLinear(torch.autograd.Function):
    """:func:`fused_ln_linear` (K4) with :func:`ln_linear_bwd` (K11) as its
    backward."""

    @staticmethod
    def forward(ctx, x2d, lnw, lnb, w, eps):
        ctx.save_for_backward(x2d, lnw, lnb, w)
        ctx.eps = eps
        return fused_ln_linear(x2d, lnw, lnb, w, eps=eps)

    @staticmethod
    def backward(ctx, g):
        grads = ln_linear_bwd(*ctx.saved_tensors, g.contiguous(), eps=ctx.eps)
        return (*grads, None)


def ln_linear(x2d, lnw, lnb, w, *, eps: float = 1e-6):
    """Differentiable :func:`fused_ln_linear`."""
    return LnLinear.apply(x2d, lnw, lnb, w, eps)
