"""Fused shifted-window MSA half-block: x + proj(MSA(LN1(x))).

Replaces the Pallas kernels tulip_tpu/ops/pallas/window_msa.py
``_kernel_masked_nat`` (heads <= 8) and ``_kernel`` (heads > 8) with one
CUDA kernel, ``csrc/window_msa.cu``.  :func:`window_msa` takes the plain
PyTorch version :func:`window_msa_ref` for a CPU tensor and launches the
kernel for a CUDA tensor; any other device raises.
"""

from __future__ import annotations

import torch

from . import build
from ..models.layers import layer_norm, linear
from ..parallel.halo import roll_hw


def window_msa_ref(x, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, *,
                   window, shift, eps: float):
    """Plain PyTorch half-block.

    x: (B, H, W, C) NHWC; wqkv (3C, C) / wproj (C, C) in torch layout;
    bias: (nh, L, L) fp32 gathered relative-position bias; mask: (nW, L, L)
    fp32 0/-100 shift mask or None.  LN statistics and the softmax are
    fp32; q/k/v, the probabilities and the head outputs are rounded to the
    activation dtype, as in the kernel.
    """
    B, H, W, C = x.shape
    wh, ww = window
    sh, sw = shift
    L = wh * ww
    nh = bias.shape[0]
    hd = C // nh
    d = x.dtype
    xr = roll_hw(x, -sh, -sw)
    xw = (xr.reshape(B, H // wh, wh, W // ww, ww, C)
          .permute(0, 1, 3, 2, 4, 5).reshape(-1, L, C))
    Bn = xw.shape[0]
    y = layer_norm(xw, lnw, lnb, eps)
    qkv = linear(y, wqkv, bqkv)
    q, k, v = qkv.reshape(Bn, L, 3, nh, hd).permute(2, 0, 3, 1, 4).unbind(0)
    logits = (q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5
    logits = logits + bias.float()
    if mask is not None:
        nW = mask.shape[0]
        logits = (logits.reshape(Bn // nW, nW, nh, L, L)
                  + mask.float()[None, :, None]).reshape(Bn, nh, L, L)
    p = torch.softmax(logits, dim=-1).to(d)
    o = (p @ v).transpose(1, 2).reshape(Bn, L, C)
    out = (linear(o, wproj, bproj).float() + xw.float()).to(d)
    out = (out.reshape(B, H // wh, W // ww, wh, ww, C)
           .permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C))
    return roll_hw(out, sh, sw)


def window_msa(x, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, *,
               window, shift, eps: float):
    """x + proj(MSA(LN1(x))) over (wh, ww) windows, shifted by ``shift``.
    Arguments as in :func:`window_msa_ref`."""
    if x.device.type == "cpu":
        return window_msa_ref(x, lnw, lnb, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, shift=shift, eps=eps)
    if x.device.type != "cuda":
        raise build.not_cuda(x)
    B, H, W, C = x.shape
    wh, ww = window
    sh, sw = shift
    nh = bias.shape[0]
    L = wh * ww
    if L != 16 or C != 32 * nh or H % wh or W % ww:
        raise NotImplementedError(
            f"window_msa kernel takes 16-token windows and head dim 32; got "
            f"window {window}, C={C}, heads={nh}, grid {H}x{W}")
    dev, d = x.device, x.dtype
    build.require(x, "x", dev, d, (B, H, W, C))
    for name, t, shape in (("lnw", lnw, (C,)), ("lnb", lnb, (C,)),
                           ("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                           ("wproj", wproj, (C, C)), ("bproj", bproj, (C,))):
        build.require(t, name, dev, d, shape)
    build.require(bias, "bias", dev, torch.float32, (nh, L, L))
    if mask is not None:
        build.require(mask, "mask", dev, torch.float32,
                      ((H // wh) * (W // ww), L, L))
    lib = build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_window_msa(
            build.dtype_code(x), x.data_ptr(), out.data_ptr(),
            lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wproj.data_ptr(), bproj.data_ptr(), bias.data_ptr(),
            build.ptr(mask), B, H, W, C, nh, wh, ww, sh, sw,
            float((C // nh) ** -0.5), float(eps), stream)
    build.check(lib, err, "window_msa")
    window_msa.launches += 1
    if nh > 8:
        window_msa.launches_many_heads += 1
    return out


window_msa.launches = 0              # kernel launches (all head counts)
window_msa.launches_many_heads = 0   # of which with > 8 heads (the K2 share)
