"""LayerNorm over the last axis of (N, C) tokens, forward and backward.

Replaces the Pallas kernels tulip_tpu/ops/pallas/ln.py ``_fwd_kernel``
(K14) and ``_bwd_kernel`` (K15) (``layer_norm_vjp``) with ``csrc/ln.cu``.
:func:`ln_fwd` and :func:`ln_bwd` take the plain PyTorch versions for CPU
tensors and launch the kernels for CUDA tensors; any other device raises.
:func:`layer_norm_fn` is the differentiable entry: it saves x and w only,
and its backward recomputes the row statistics.

Both dtypes run ``ln_fwd_reg_kernel`` / ``ln_bwd_reg_kernel`` (rows held in
registers as 16-byte chunks, a persistent grid; the backward's dw / db
summed to the end in the same launch) under the launch plan
:func:`ln_plan`, for C a whole number of chunks up to 1,536.  Other bf16
widths raise; other fp32 widths (C % 4 != 0, or over 1,536) run
``ln_fwd_row_f32_kernel`` / ``ln_bwd_row_f32_kernel``, one warp a row,
whose backward ends its sums in its launch too.

w and b are read as fp32 whatever the activation dtype (the train step
keeps fp32 master weights); dw and db are summed in fp32 and returned in
the parameters' dtype.
"""

from __future__ import annotations

import math

import torch

from . import build
from .mlp import NUM_SMS
from ..models.layers import layer_norm, wide

_WARPS = 8             # csrc/ln.cu kLnWarps: warps per block
_CHUNK = {torch.bfloat16: 8, torch.float32: 4}   # values in a 16-byte chunk
_MAX_CPL = {torch.bfloat16: 6, torch.float32: 12}   # csrc/ln.cu max_cpl
_REG_CPL = 6           # csrc/ln.cu kRegCpl: above it fp32's sums leave registers


def _blocks_per_sm(cpl) -> int:
    """CTAs of 256 threads an SM holds: what csrc/ln.cu blocks_per_sm
    builds each register kernel for (cpl None: the one-warp-a-row form)."""
    return 2 if cpl is None or cpl <= 3 else 1


def _stride(C: int) -> int:
    """Floats of a [dw | db] partial row: 2C rounded up to whole float4."""
    return -(-2 * C // 4) * 4


def ln_plan(N: int, C: int, dtype, backward: bool = False) -> dict:
    """Launch plan of the LayerNorm kernels from the shape and dtype alone.

    kernel        "reg" (``ln_fwd_reg_kernel`` / ``ln_bwd_reg_kernel``)
                  where C is a whole number of 16-byte chunks (8 bf16, 4
                  fp32 values) that 32 lanes hold in at most ``_MAX_CPL``
                  chunks each (C <= 1,536 in both types); else, fp32 only,
                  "row" (``ln_fwd_row_f32_kernel`` /
                  ``ln_bwd_row_f32_kernel``: one warp a row, 4-byte
                  accesses).  Other bf16 widths raise NotImplementedError;
    lanes         L, the lanes of a row's group: the largest power of two
                  up to 32 with 3 L <= C / chunk, the row's 16-byte chunks
                  (1 for fewer chunks); lane s of the group holds chunks s,
                  s + L, ... (``cpl`` of them, the last past the row's end
                  where L does not divide the chunks; above ``_REG_CPL``,
                  fp32 only, the forward reads w / b and the backward keeps
                  its dw / db sums in shared memory).  "row": 32, cpl None;
    rows          32 / L rows a warp takes at a time (a row group);
    ctas          the persistent grid: as many CTAs as the SMs hold at
                  once, fewer where the row groups do not give each warp
                  one;
    rows_per_cta  CTA i takes rows [i rows_per_cta, (i + 1) rows_per_cta),
                  a multiple of ``rows``; its warp w takes the row groups
                  w, w + 8, w + 16, ... of that range;
    group         backward: the CTAs whose fp32 partials [dw | db] the last
                  of them adds in CTA order (ceil(sqrt(ctas))); the last of
                  those group sums adds them in group order;
    part, gpart   backward: the shapes of the partials (ctas, S) and of
                  the group sums (ceil(ctas / group), S), S = 2C rounded
                  up to a multiple of 4 (:func:`_stride`)."""
    if N <= 0 or C <= 0:
        raise ValueError(f"LayerNorm of an empty matrix ({N}, {C})")
    if dtype not in _CHUNK:
        raise TypeError(f"LayerNorm kernels take float32 or bfloat16, got "
                        f"{dtype}")
    chunk = _CHUNK[dtype]
    chunks = C // chunk
    if C % chunk == 0 and chunks <= 32 * _MAX_CPL[dtype]:
        lanes = 1
        while lanes < 32 and 3 * 2 * lanes <= chunks:
            lanes *= 2
        kernel, cpl = "reg", -(-chunks // lanes)
    elif dtype == torch.bfloat16:
        raise NotImplementedError(
            f"the bf16 LayerNorm kernels take C a multiple of {chunk} up to "
            f"{32 * _MAX_CPL[dtype] * chunk}; got C={C}")
    else:
        kernel, lanes, cpl = "row", 32, None
    rows = 32 // lanes
    groups = -(-N // rows)
    ctas = min(_blocks_per_sm(cpl) * NUM_SMS, -(-groups // _WARPS))
    rpc = -(-groups // ctas) * rows
    ctas = -(-N // rpc)
    plan = dict(kernel=kernel, lanes=lanes, cpl=cpl, rows=rows, ctas=ctas,
                rows_per_cta=rpc, group=None, part=None, gpart=None)
    if backward:
        group = math.isqrt(ctas - 1) + 1
        plan.update(group=group, part=(ctas, _stride(C)),
                    gpart=(-(-ctas // group), _stride(C)))
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
    return N, C


def _aligned(t, name):
    """t where it starts on a 16-byte boundary (the register kernels move
    rows in 16-byte pieces).  bf16 raises otherwise; an fp32 t, which the
    kernels took at any alignment before they held rows in registers, is
    copied to a fresh, aligned tensor (the same values, so the same
    result)."""
    if t.data_ptr() % 16 and t.dtype == torch.float32:
        return t.clone()
    build.require_aligned(name, t)
    return t


def _f32(t, name, device, C):
    """t as a contiguous, 16-byte aligned fp32 (C,) tensor: t itself where
    it already is one (the bf16 kernels read it in 16-byte pieces)."""
    if (t.dtype != torch.float32 or not t.is_contiguous()
            or t.data_ptr() % 16):
        t = t.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
    build.require(t, name, device, torch.float32, (C,))
    return t


# (device index, stream) -> [fp32 scratch, tickets] of the backward.
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
    if p["kernel"] == "reg":
        x2d = _aligned(x2d, "x")
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
    dtype; dw and db are fp32.  One launch: dx and, from the last CTA, dw
    and db."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_ref(x2d, w, g, eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    N, C = _check(x2d, w, "ln_bwd")
    dev = x2d.device
    build.require(g, "g", dev, x2d.dtype, (N, C))
    wf = _f32(w, "w", dev, C)
    p = ln_plan(N, C, x2d.dtype, backward=True)
    if p["kernel"] == "reg":
        x2d, g = _aligned(x2d, "x"), _aligned(g, "g")
    lib = build.load()
    dx = torch.empty_like(x2d)
    S = p["part"][1]
    dwdb = torch.empty(S, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        n_part = p["part"][0] * S
        scratch, tickets = _bwd_workspace(dev, stream,
                                          n_part + p["gpart"][0] * S)
        err = lib.tulip_ln_bwd(
            build.dtype_code(x2d), x2d.data_ptr(), wf.data_ptr(),
            g.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
            scratch[n_part:].data_ptr(), tickets.data_ptr(),
            dwdb.data_ptr(), N, C, p["lanes"], p["rows_per_cta"], p["ctas"],
            p["group"], float(eps), stream)
    build.check(lib, err, "ln_bwd")
    ln_bwd.launches += 1
    return dx, dwdb[:C], dwdb[C:2 * C]


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
