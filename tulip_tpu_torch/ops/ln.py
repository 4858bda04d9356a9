"""LayerNorm over the last axis of (N, C) tokens, forward and backward.

Replaces the Pallas kernels tulip_tpu/ops/pallas/ln.py ``_fwd_kernel``
(K14) and ``_bwd_kernel`` (K15) (``layer_norm_vjp``) with ``csrc/ln.cu``.
:func:`ln_fwd` and :func:`ln_bwd` take the plain PyTorch versions for CPU
tensors and launch the kernels for CUDA tensors; any other device raises.
:func:`layer_norm_fn` is the differentiable entry: it saves x and w only,
and its backward recomputes the row statistics.

The dtype decides the kernel.  bf16 runs ``ln_fwd_reg_kernel`` /
``ln_bwd_reg_kernel`` (rows held in registers as 16-byte chunks, a
persistent grid; the backward's dw / db summed to the end in the same
launch) under the launch plan :func:`ln_plan`, for C a multiple of 8 up to
1,536; other bf16 widths raise.  fp32 runs ``ln_fwd_kernel`` /
``ln_bwd_kernel``, one warp per row, the parity path, whose backward
partials ``colsum`` adds.

w and b are read as fp32 whatever the activation dtype (the train step
keeps fp32 master weights); dw and db are summed in fp32 and returned in
the parameters' dtype.
"""

from __future__ import annotations

import math

import torch

from . import build
from .mlp import NUM_SMS
from .reduce import colsum
from ..models.layers import layer_norm, wide

_WARPS = 8             # csrc/ln.cu kLnWarps: warps per block
_TARGET_BLOCKS = 1024  # fp32: partial (2, C) sums the backward writes, at most
_CHUNK = 8             # bf16 values in a 16-byte chunk
_MAX_CPL = 6           # csrc/ln.cu lnr::kMaxCpl: chunks a lane holds, at most


def _blocks_per_sm(cpl: int) -> int:
    """CTAs of 256 threads an SM holds: what csrc/ln.cu lnr::blocks_per_sm
    builds each kernel for."""
    return 2 if cpl <= 3 else 1


def ln_plan(N: int, C: int, dtype, backward: bool = False) -> dict:
    """Launch plan of the LayerNorm kernels from the shape and dtype alone.

    bf16 (``ln_fwd_reg_kernel`` / ``ln_bwd_reg_kernel``):

    lanes         L, the lanes of a row's group: the largest power of two
                  up to 32 with 3 L <= C / 8, the row's 16-byte chunks (1
                  for fewer chunks); lane s of the group holds chunks s,
                  s + L, ... (``cpl`` of them, the last past the row's end
                  where L does not divide the chunks);
    rows          32 / L rows a warp takes at a time (a row group);
    ctas          the persistent grid: as many CTAs as the SMs hold at
                  once, fewer where the row groups do not give each warp
                  one;
    rows_per_cta  CTA i takes rows [i rows_per_cta, (i + 1) rows_per_cta),
                  a multiple of ``rows``; its warp w takes the row groups
                  w, w + 8, w + 16, ... of that range;
    group         backward: the CTAs whose (2, C) fp32 partials [dw | db]
                  the last of them adds in CTA order (ceil(sqrt(ctas)));
                  the last of those group sums adds them in group order;
    part, gpart   backward: the shapes of the partials (ctas, 2C) and of
                  the group sums (ceil(ctas / group), 2C).

    fp32 (``ln_fwd_kernel`` / ``ln_bwd_kernel``): one warp per row
    (``lanes`` 32, lanes strided over the columns), 8 rows per block
    forward; backward blocks of a multiple of 8 rows, at most about
    _TARGET_BLOCKS of them, whose (blocks, 2C) partials ``colsum`` adds.

    Raises NotImplementedError for bf16 widths the kernels do not take (C
    not a multiple of 8, or over 1,536)."""
    if N <= 0 or C <= 0:
        raise ValueError(f"LayerNorm of an empty matrix ({N}, {C})")
    if dtype == torch.float32:
        if backward:
            rpc = -(-N // _TARGET_BLOCKS)
            rpc = max(_WARPS, -(-rpc // _WARPS) * _WARPS)
        else:
            rpc = _WARPS
        ctas = -(-N // rpc)
        return dict(kernel="warp", lanes=32, cpl=None, rows=1, ctas=ctas,
                    rows_per_cta=rpc, group=None,
                    part=(ctas, 2 * C) if backward else None, gpart=None)
    if dtype != torch.bfloat16:
        raise TypeError(f"LayerNorm kernels take float32 or bfloat16, got "
                        f"{dtype}")
    chunks = C // _CHUNK
    lanes = 1
    while lanes < 32 and 3 * 2 * lanes <= chunks:
        lanes *= 2
    cpl = -(-chunks // lanes)
    if C % _CHUNK or cpl > _MAX_CPL:
        raise NotImplementedError(
            f"the bf16 LayerNorm kernels take C a multiple of {_CHUNK} up to "
            f"{32 * _MAX_CPL * _CHUNK}; got C={C}")
    rows = 32 // lanes
    groups = -(-N // rows)
    ctas = min(_blocks_per_sm(cpl) * NUM_SMS, -(-groups // _WARPS))
    rpc = -(-groups // ctas) * rows
    ctas = -(-N // rpc)
    plan = dict(kernel="reg", lanes=lanes, cpl=cpl, rows=rows, ctas=ctas,
                rows_per_cta=rpc, group=None, part=None, gpart=None)
    if backward:
        group = math.isqrt(ctas - 1) + 1
        plan.update(group=group, part=(ctas, 2 * C),
                    gpart=(-(-ctas // group), 2 * C))
    return plan


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
    if x2d.dtype == torch.bfloat16:
        build.require_aligned("x", x2d)
    return N, C


def _f32(t, name, device, C):
    """t as a contiguous, 16-byte aligned fp32 (C,) tensor: t itself where
    it already is one (the bf16 kernels read it in 16-byte pieces)."""
    if (t.dtype != torch.float32 or not t.is_contiguous()
            or t.data_ptr() % 16):
        t = t.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
    build.require(t, name, device, torch.float32, (C,))
    return t


# (device index, stream) -> [fp32 scratch, tickets] of the bf16 backward.
# The tickets are 0 between launches (the CTAs that draw the last ones
# reset them), so the launches of one stream, which run one after another,
# share them; two streams never do.  The scratch grows to the largest
# part + gpart a launch has needed.
_workspace: dict = {}
_TICKETS = 64   # 1 + groups of the backward's sum: ceil(sqrt(264)) + 1 = 18


def _bwd_workspace(dev, stream, floats):
    ws = _workspace.setdefault((dev.index, stream), [None, None])
    if ws[0] is None or ws[0].numel() < floats:
        ws[0] = torch.empty(floats, device=dev, dtype=torch.float32)
    if ws[1] is None:
        ws[1] = torch.zeros(_TICKETS, device=dev, dtype=torch.int32)
    return ws


def ln_fwd(x2d, w, b, eps: float = 1e-6):
    """LayerNorm of x2d (N, C) with affine w, b (C,)."""
    if x2d.device.type == "cpu":
        return layer_norm_ref(x2d, w, b, eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, C = _check(x2d, w, "ln_fwd")
    dev = x2d.device
    wf, bf = _f32(w, "w", dev, C), _f32(b, "b", dev, C)
    p = ln_plan(N, C, x2d.dtype)
    lib = build.load()
    y = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = lib.tulip_ln_fwd(
            build.dtype_code(x2d), x2d.data_ptr(), wf.data_ptr(),
            bf.data_ptr(), y.data_ptr(), N, C, p["lanes"], p["rows_per_cta"],
            p["ctas"], float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ln_fwd")
    ln_fwd.launches += 1
    return y


ln_fwd.launches = 0


def ln_bwd(x2d, w, g, eps: float = 1e-6):
    """(dx, dw, db) of :func:`ln_fwd` at upstream gradient g (N, C) in x's
    dtype; dw and db are fp32.  bf16: one launch (dx and, from the last
    CTA, dw and db); fp32: the kernel, then ``colsum`` of its partials."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_ref(x2d, w, g, eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, C = _check(x2d, w, "ln_bwd")
    dev = x2d.device
    build.require(g, "g", dev, x2d.dtype, (N, C))
    wf = _f32(w, "w", dev, C)
    p = ln_plan(N, C, x2d.dtype, backward=True)
    lib = build.load()
    dx = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x2d.dtype == torch.bfloat16:
            build.require_aligned("g", g)
            n_part = p["part"][0] * 2 * C
            scratch, tickets = _bwd_workspace(
                dev, stream, n_part + p["gpart"][0] * 2 * C)
            part, gpart = scratch, scratch[n_part:]
            dwdb = torch.empty((2, C), device=dev, dtype=torch.float32)
            group = p["group"]
        else:
            part = torch.empty(p["part"], device=dev, dtype=torch.float32)
            gpart = tickets = dwdb = None
            group = 0
        err = lib.tulip_ln_bwd(
            build.dtype_code(x2d), x2d.data_ptr(), wf.data_ptr(),
            g.data_ptr(), dx.data_ptr(), part.data_ptr(), build.ptr(gpart),
            build.ptr(tickets), build.ptr(dwdb), N, C, p["lanes"],
            p["rows_per_cta"], p["ctas"], group, float(eps), stream)
    build.check(lib, err, "ln_bwd")
    ln_bwd.launches += 1
    if dwdb is None:
        dwdb = colsum(part).view(2, C)
    return dx, dwdb[0], dwdb[1]


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
