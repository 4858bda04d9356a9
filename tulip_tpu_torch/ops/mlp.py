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

In bf16 K3, K10's token pass and the weight-gradient products run on the
tensor cores (``csrc/mma.cuh``) under the launch plans computed here
(:func:`two_matmul_plan`, :func:`dy_splits`, ``reduce.tn_gemm_plan``); in
fp32 they run on the FMA kernels, the parity path.
"""

from __future__ import annotations

import torch

from . import build
from .reduce import colsum, mn_tile, tn_gemm
from ..models.layers import gelu, layer_norm, leaky_relu, linear, wide

ACTS = {"gelu": 0, "leaky": 1}
SMEM_MAX = 232448      # shared bytes one block can use on sm_90
# shared bytes of a block when two share an SM: (228 KB - 2 x 1 KB that the
# system keeps per block) / 2.  K3's epilogues (bias, GELU, rounding) and
# its waits on L2 overlap only with another block's work, and two blocks
# per SM measured 1.2-1.7x faster than one with a longer hidden slice, the
# splits' fp32 partial sums included (NVIDIA H100 80GB HBM3, 700 W).
SMEM_TWO_PER_SM = (233472 - 2 * 1024) // 2
NUM_SMS = 132          # H100 SXM: the grid size the plans aim for
_ROWS = 64             # token rows per CTA of the tensor-core kernels
_HID_TILE = 128        # hidden units per tile (csrc/mlp.cu kHidTile)
_STAGES = 3            # csrc/mlp.cu kMlpStages
_SUB = 8192            # bytes of a 64 x 64 bf16 operand tile


def check_widths(C: int, Hd: int, O: int, residual: bool, what: str) -> None:
    """Raise for widths the K3 / K10 kernels do not take."""
    if C % 32 or Hd % 32 or (residual and O != C):
        raise NotImplementedError(
            f"{what} takes C, Hd multiples of 32 and O == C with residual; "
            f"got C={C}, Hd={Hd}, O={O}, residual={residual}")


def two_matmul_plan(N: int, C: int, Hd: int, O: int) -> dict:
    """Launch plan of the bf16 tensor-core K3 (``csrc/mlp.cu``
    two_matmul_tc_kernel), grid (row tiles, splits):

    rows      token rows per CTA (64, one warpgroup);
    resident  LN(x) is made in the kernel and kept in shared memory
              (C <= 256), else made by a pass of its own and streamed;
    hs        hidden units per split, a multiple of 128: as many as fit
              beside the ring (and y) as bf16 rows when two blocks share
              an SM (``SMEM_TWO_PER_SM``; at least two tiles fit for every
              width), fewer when that gives about one CTA per SM;
    splits    ceil(Hd / hs) >= 1; above 1 the splits' fp32 partial sums
              are added in split order by a second launch;
    bn2       output columns per tile of the second product;
    smem      dynamic shared bytes: 1 KB alignment room + ring + a + y,
              at most ``SMEM_TWO_PER_SM`` < ``SMEM_MAX`` for every width (a
              wide y is streamed).  The C entry point recomputes it and
              refuses a plan that differs."""
    resident = C <= 256
    stage = _HID_TILE * 128 + (0 if resident else _SUB)
    fixed = 1024 + _STAGES * stage + (-(-C // 64) * _SUB if resident else 0)
    fit = (SMEM_TWO_PER_SM - fixed) // (_HID_TILE * _ROWS * 2)   # tiles, >= 2
    tiles = -(-Hd // _HID_TILE)
    row_tiles = -(-N // _ROWS)
    want = max(-(-tiles // fit), NUM_SMS // row_tiles)
    per = -(-tiles // min(tiles, want))
    splits = -(-tiles // per)
    hs = per * _HID_TILE
    return dict(rows=_ROWS, resident=resident, hs=hs, splits=splits,
                bn2=16 if O <= 16 else 96 if O % 96 == 0 else 128,
                stages=_STAGES, smem=fixed + hs * _ROWS * 2)


def dy_splits(N: int, C: int, Hd: int) -> int:
    """Splits of the hidden dimension in K10's dy = dh @ W1 launch (grid:
    row tiles x column tiles x splits): 1 when the first two fill the SMs,
    else enough for about one CTA per SM, each split at least four 64-deep
    tiles and every tile in exactly one split."""
    ctas = -(-N // _ROWS) * -(-C // mn_tile(C))
    kt = -(-Hd // 64)
    want = max(1, min(NUM_SMS // ctas, kt // 4))
    return -(-kt // -(-kt // want))


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
    check_widths(C, Hd, O, residual, "two_matmul kernel")
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
    y = partial = None
    plan = dict(hs=0, splits=0, resident=0, bn2=0, smem=0)
    if d == torch.bfloat16:
        if O % 8:
            raise NotImplementedError(
                f"bf16 two_matmul kernel takes O % 8 == 0, got O={O}")
        for name, t in (("x", x2d), ("w1", w1), ("w2", w2), ("lnw", lnw),
                        ("lnb", lnb)):
            build.require_aligned(name, t)
        plan = two_matmul_plan(N, C, Hd, O)
        if lnw is not None and not plan["resident"]:
            y = torch.empty_like(x2d)
        if plan["splits"] > 1:
            partial = torch.empty((plan["splits"], N, O), device=dev,
                                  dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_two_matmul(
            build.dtype_code(x2d), ACTS[act], x2d.data_ptr(), out.data_ptr(),
            build.ptr(lnw), build.ptr(lnb), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), build.ptr(b2), build.ptr(y), build.ptr(partial),
            N, C, Hd, O, int(residual), float(eps), plan["hs"],
            plan["splits"], int(plan["resident"]), plan["bn2"], plan["smem"],
            stream)
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
    (recompute, da, dh, dy, dx; scratch y, a, dh; in bf16 also the rows' LN
    statistics and dy in fp32, one per split of :func:`dy_splits`) then the
    weight-gradient products and column sums of ``csrc/reduce.cu``.
    Outputs as in :func:`two_matmul_bwd_ref`."""
    if x2d.device.type == "cpu":
        return two_matmul_bwd_ref(x2d, lnw, lnb, w1, b1, w2, b2, g, act=act,
                                  residual=residual, eps=eps)
    if x2d.device.type != "cuda":
        raise build.not_cuda(x2d)
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    N, C = x2d.shape
    Hd, O = w1.shape[0], w2.shape[0]
    check_widths(C, Hd, O, residual, "two_matmul backward")
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
    f32 = torch.float32
    dx, a, dh = empty(N, C), empty(N, Hd), empty(N, Hd)
    y = part = stat = dyp = None
    splits = 0
    if lnw is not None:
        y = empty(N, C)
        part = empty(-(-N // 16), 2 * C, dt=f32)
    if d == torch.bfloat16:
        if O % 8:
            raise NotImplementedError(
                f"bf16 two_matmul backward takes O % 8 == 0, got O={O}")
        for name, t in (("x", x2d), ("g", g), ("w1", w1), ("w2", w2),
                        ("lnw", lnw), ("lnb", lnb)):
            build.require_aligned(name, t)
        splits = dy_splits(N, C, Hd)
        dyp = empty(splits, N, C, dt=f32)
        if lnw is not None:
            stat = empty(N, 2, dt=f32)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tulip_two_matmul_bwd(
            build.dtype_code(x2d), ACTS[act], x2d.data_ptr(), g.data_ptr(),
            build.ptr(lnw), build.ptr(lnb), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), build.ptr(y), a.data_ptr(),
            dh.data_ptr(), build.ptr(part), build.ptr(stat), build.ptr(dyp),
            N, C, Hd, O, int(residual), float(eps), splits, stream)
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
