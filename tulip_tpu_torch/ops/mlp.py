"""Fused [LayerNorm ->] matmul -> activation -> matmul [-> residual], and
LayerNorm -> matmul.

Replaces the Pallas kernels tulip_tpu/ops/pallas/mlp.py ``_kernel``
(:func:`fused_two_matmul`: the Swin MLP half-block and the folded
norm_up + ps_head + decoder_pred head) and ``_kernel_ln_mm``
(:func:`fused_ln_linear`: the patch-merging LN + reduction) with the CUDA
kernels of ``csrc/mlp.cu``.  Each wrapper takes its plain PyTorch version
(``*_ref``) for a CPU tensor and launches its kernel for a CUDA tensor; any
other device raises.
"""

from __future__ import annotations

import torch

from . import build
from ..models.layers import gelu, layer_norm, leaky_relu, linear

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
    o = linear(h, w2, b2).float()
    if residual:
        o = o + x2d.float()
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
