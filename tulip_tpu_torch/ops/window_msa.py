"""Fused shifted-window MSA half-block: x + proj(MSA(LN1(x))).

Replaces the Pallas kernels tulip_tpu/ops/pallas/window_msa.py
``_kernel_masked_nat`` (heads <= 8) and ``_kernel`` (heads > 8) with one
CUDA kernel, ``csrc/window_msa.cu``.  :func:`window_msa` takes the plain
PyTorch version :func:`window_msa_ref` for a CPU tensor and launches the
kernel for a CUDA tensor; any other device raises.

The same kernel stands behind the JAX package's two other layouts, which
its ``TULIP_TPU_MSA_GROUPED`` / ``TULIP_TPU_MSA_NAT`` switches select:
:func:`window_msa_grouped` (``_kernel_masked``: window-major token groups,
the caller rolls and partitions) and :func:`window_msa_nat`
(``_kernel_nat``: natural row strips, the caller rolls).  Both take the
compact (nh, L, L) bias and (nW, L, L) mask, not the TPU kernels'
block-diagonal (nh, 128, 128) expansions.
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


def _check(x, C, nh, L, params, bias, mask, n_mask):
    """Validate the operands of a launch."""
    dev, d = x.device, x.dtype
    if L != 16 or C != 32 * nh:
        raise NotImplementedError(
            f"window_msa kernel takes 16-token windows and head dim 32; got "
            f"{L}-token windows, C={C}, heads={nh}")
    build.require(x, "x", dev, d, tuple(x.shape))
    lnw, lnb, wqkv, bqkv, wproj, bproj = params
    for name, t, shape in (("lnw", lnw, (C,)), ("lnb", lnb, (C,)),
                           ("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                           ("wproj", wproj, (C, C)), ("bproj", bproj, (C,))):
        build.require(t, name, dev, d, shape)
    build.require(bias, "bias", dev, torch.float32, (nh, L, L))
    if mask is not None:
        build.require(mask, "mask", dev, torch.float32, (n_mask, L, L))


def _launch(x, B, H, W, C, params, bias, mask, window, shift, eps, what):
    """tulip_window_msa on x read as a (B, H, W, C) grid."""
    wh, ww = window
    nh = bias.shape[0]
    if H % wh or W % ww:
        raise NotImplementedError(f"{what}: grid {H}x{W} is not a multiple "
                                  f"of window {window}")
    _check(x, C, nh, wh * ww, params, bias, mask, (H // wh) * (W // ww))
    lib = build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tulip_window_msa(
            build.dtype_code(x), x.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in params), bias.data_ptr(),
            build.ptr(mask), B, H, W, C, nh, wh, ww, shift[0], shift[1],
            float((C // nh) ** -0.5), float(eps), stream)
    build.check(lib, err, what)
    return out


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
    out = _launch(x, B, H, W, C, (lnw, lnb, wqkv, bqkv, wproj, bproj), bias,
                  mask, window, shift, eps, "window_msa")
    window_msa.launches += 1
    if bias.shape[0] > 8:
        window_msa.launches_many_heads += 1
    return out


window_msa.launches = 0              # kernel launches (all head counts)
window_msa.launches_many_heads = 0   # of which with > 8 heads (the K2 share)


# ---------------------------------------------------------------------------
# The grouped window-major layout (window_msa.py:_kernel_masked)
# ---------------------------------------------------------------------------

def group_partition(x, window, group: int):
    """(B, H, W, C) -> (B, nG, group * L, C): ``group`` horizontally
    adjacent windows to a group, tokens window-major inside it, the layout
    of tulip_tpu/models/swin.py:514-515."""
    B, H, W, C = x.shape
    wh, ww = window
    nH, nWg = H // wh, W // ww // group
    xg = x.reshape(B, nH, wh, nWg, group, ww, C).permute(0, 1, 3, 4, 2, 5, 6)
    return xg.reshape(B, nH * nWg, group * wh * ww, C)


def group_unpartition(xg, grid, window, group: int):
    """Inverse of :func:`group_partition` (swin.py:519-520)."""
    B, _, _, C = xg.shape
    H, W = grid
    wh, ww = window
    nH, nWg = H // wh, W // ww // group
    x = xg.reshape(B, nH, nWg, group, wh, ww, C).permute(0, 1, 4, 2, 3, 5, 6)
    return x.reshape(B, H, W, C)


def _as_windows(xg, L):
    B, nG, GL, C = xg.shape
    if GL % L:
        raise ValueError(f"a group of {GL} tokens does not hold whole "
                         f"{L}-token windows")
    return B * nG * (GL // L), C


def window_msa_grouped_ref(xg, lnw, lnb, wqkv, bqkv, wproj, bproj, bias,
                           mask, *, eps: float):
    """Plain PyTorch half-block on grouped tokens xg (B, nG, GL, C): every
    L consecutive rows are one window (L = bias.shape[1]), in the window
    order of the partition, so window n takes mask[n % nW].  No shift: the
    caller rolled before partitioning."""
    L = bias.shape[1]
    n, C = _as_windows(xg, L)
    out = window_msa_ref(xg.reshape(1, n, L, C), lnw, lnb, wqkv, bqkv, wproj,
                         bproj, bias, mask, window=(1, L), shift=(0, 0),
                         eps=eps)
    return out.reshape(xg.shape)


def window_msa_grouped(xg, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask,
                       *, eps: float):
    """x + proj(MSA(LN1(x))) on grouped tokens; arguments as in
    :func:`window_msa_grouped_ref`."""
    if xg.device.type == "cpu":
        return window_msa_grouped_ref(xg, lnw, lnb, wqkv, bqkv, wproj, bproj,
                                      bias, mask, eps=eps)
    if xg.device.type != "cuda":
        raise build.not_cuda(xg)
    nh, L = bias.shape[0], bias.shape[1]
    n, C = _as_windows(xg, L)
    nW = n if mask is None else mask.shape[0]
    if n % nW:
        raise ValueError(f"{n} windows are not a multiple of the mask's {nW}")
    params = (lnw, lnb, wqkv, bqkv, wproj, bproj)
    _check(xg, C, nh, L, params, bias, mask, nW)
    lib = build.load()
    out = torch.empty_like(xg)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = lib.tulip_window_msa_grouped(
            build.dtype_code(xg), xg.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in params), bias.data_ptr(),
            build.ptr(mask), n, nW, C, nh, float((C // nh) ** -0.5),
            float(eps), stream)
    build.check(lib, err, "window_msa_grouped")
    window_msa_grouped.launches += 1
    return out


window_msa_grouped.launches = 0


# ---------------------------------------------------------------------------
# Natural row strips (window_msa.py:_kernel_nat)
# ---------------------------------------------------------------------------

def _nat_grid(x4, bias, nH):
    R, wh, W, C = x4.shape
    L = bias.shape[1]
    if R % nH or L % wh:
        raise ValueError(f"x4 {tuple(x4.shape)} does not hold whole images "
                         f"of {nH} strips of {L}-token windows")
    return R // nH, nH * wh, W, C, (wh, L // wh)


def window_msa_nat_ref(x4, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask,
                       *, nH: int, eps: float):
    """Plain PyTorch half-block on natural row strips x4 (R, wh, W, C) with
    R = B * nH: a reshape of the (B, H, W, C) grid.  No shift: the caller
    rolled.  mask: (nW, L, L) over one image's windows, or None."""
    B, H, W, C, window = _nat_grid(x4, bias, nH)
    out = window_msa_ref(x4.reshape(B, H, W, C), lnw, lnb, wqkv, bqkv, wproj,
                         bproj, bias, mask, window=window, shift=(0, 0),
                         eps=eps)
    return out.reshape(x4.shape)


def window_msa_nat(x4, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, *,
                   nH: int, eps: float):
    """x + proj(MSA(LN1(x))) on natural row strips; arguments as in
    :func:`window_msa_nat_ref`."""
    if x4.device.type == "cpu":
        return window_msa_nat_ref(x4, lnw, lnb, wqkv, bqkv, wproj, bproj,
                                  bias, mask, nH=nH, eps=eps)
    if x4.device.type != "cuda":
        raise build.not_cuda(x4)
    B, H, W, C, window = _nat_grid(x4, bias, nH)
    out = _launch(x4, B, H, W, C, (lnw, lnb, wqkv, bqkv, wproj, bproj), bias,
                  mask, window, (0, 0), eps, "window_msa_nat")
    window_msa_nat.launches += 1
    return out


window_msa_nat.launches = 0
