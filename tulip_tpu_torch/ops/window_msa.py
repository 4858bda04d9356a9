"""Fused shifted-window MSA half-block: x + proj(MSA(LN1(x))).

Replaces the Pallas kernels tulip_tpu/ops/pallas/window_msa.py
``_kernel_masked_nat`` (heads <= 8) and ``_kernel`` (heads > 8) with the
CUDA kernels of ``csrc/window_msa.cu``.  :func:`window_msa` takes the plain
PyTorch version :func:`window_msa_ref` for a CPU tensor and launches a
kernel for a CUDA tensor; any other device raises.

The file holds two device kernels and the dtype decides between them, both
on the tensor cores with 64 token rows = 4 windows per CTA and the heads
split over CTAs where the rows are few or shared memory forces it: bf16
runs ``window_msa_tc_kernel`` under the launch plan
:func:`window_msa_plan`, fp32 ``window_msa_tf32_kernel`` in split TF32
(three TF32 products a product, about fp32's accuracy) under
:func:`window_msa_plan_f32`; ``window_msa_sum_kernel`` /
``window_msa_sum_f32_kernel`` add the splits' partial sums in split order.

The same kernels stand behind the JAX package's two other layouts, which
its ``TULIP_TPU_MSA_GROUPED`` / ``TULIP_TPU_MSA_NAT`` switches select:
:func:`window_msa_grouped` (``_kernel_masked``: window-major token groups,
the caller rolls and partitions) and :func:`window_msa_nat`
(``_kernel_nat``: natural row strips, the caller rolls).  Both take the
compact (nh, L, L) bias and (nW, L, L) mask, not the TPU kernels'
block-diagonal (nh, 128, 128) expansions, and both take the plan of the
default entry for the same (T, C, nh), so the three entries give the same
bits on the same tokens.
"""

from __future__ import annotations

import torch

from . import build
from .mlp import NUM_SMS, SMEM_MAX
from ..models.layers import layer_norm, linear
from ..parallel.halo import roll_hw

_ROWS = 64             # token rows per CTA: four 16-token windows
_SUB = 8192            # bytes of a 64 x 64 bf16 operand tile
_TILE_B = 96 * 128     # bytes of a weight tile: 96 rows of 64 bf16
_TABLE = _ROWS * 8     # the tile's token offsets
_RESIDENT_C = 1024     # widest LN1(x) kept in shared memory (kMsaResidentC)
# fp32 partial sums a split launch may write where shared memory does not
# force the split: what stays in the card's 50 MB L2 beside the weights
PARTIAL_CAP = 32 << 20
SM_SMEM = 233472       # shared bytes of an SM; a block costs 1 KB beside its own
# narrowest width whose heads are split for parallelism.  Below it a
# launch is bound by its bytes, a CTA's whole chain is at most 24 weight
# tiles, and the partial sums would be several times the activations.
_SPLIT_C = 384


def plan_smem(C: int, hs: int, stages: int) -> int:
    """Dynamic shared bytes of a window_msa_tc_kernel block with hs heads:
    1 KB alignment room + the ring (a weight tile a stage, and a tile of y
    where y is streamed) + ao (a 64 x 64 tile per two heads) + y where it
    is resident + the offset table."""
    resident = C <= _RESIDENT_C
    return (1024 + stages * (_TILE_B + (0 if resident else _SUB))
            + -(-hs // 2) * _SUB + (-(-C // 64) * _SUB if resident else 0)
            + _TABLE)


# shared bytes of the fp32 kernel (csrc/window_msa.cu kMsaF32Fixed) beside
# its ao tiles: 1 KB alignment room, three ring stages (a 96-row weight
# tile and the 64 x rows, 32 fp32 each, as hi and lo), each warp's 16 x 36
# float copy of v, the rows' LN statistics and the offset table
F32_FIXED = (1024 + 3 * 2 * (96 + _ROWS) * 128 + 4 * 16 * 36 * 4 + _ROWS * 8
             + _TABLE)
F32_HEAD = 2 * _SUB    # a head's ao tiles (64 x 32 fp32), hi and lo


def window_msa_plan_f32(T: int, C: int, nh: int) -> dict:
    """Launch plan of the fp32 split-TF32 half-block (``csrc/window_msa.cu``
    window_msa_tf32_kernel), grid (row tiles, splits):

    rows      token rows per CTA (64 = four windows, one warpgroup);
    hs        heads per split: at most the six whose ao tiles fit one
              block's shared memory beside the ring; fewer where the row
              tiles leave SMs idle (one block per SM), for about one CTA
              per SM; more again while the partial sums exceed
              ``PARTIAL_CAP`` (unless shared memory forces the split);
    splits    ceil(nh / hs) >= 1; above 1 the splits' fp32 partial sums
              (splits, T, C) are added in split order by a second launch
              (``sum_launch``);
    stages    ring stages (3);
    smem      ``F32_FIXED`` + hs x ``F32_HEAD`` <= ``SMEM_MAX``.  The C
              entry point recomputes it and refuses a plan that differs."""
    row_tiles = -(-T // _ROWS)
    hs_fit = min(nh, (SMEM_MAX - F32_FIXED) // F32_HEAD)
    min_splits = -(-nh // hs_fit)
    hs = -(-nh // max(min_splits, min(nh, NUM_SMS // row_tiles)))
    while (-(-nh // hs) > min_splits
           and -(-nh // hs) * T * C * 4 > PARTIAL_CAP):
        hs += 1
    splits = -(-nh // hs)
    return dict(rows=_ROWS, hs=hs, splits=splits, stages=3,
                smem=F32_FIXED + hs * F32_HEAD, sum_launch=splits > 1)


def window_msa_plan(T: int, C: int, nh: int) -> dict:
    """Launch plan of the bf16 tensor-core half-block (``csrc/window_msa.cu``
    window_msa_tc_kernel), grid (row tiles, splits), from the shape alone:

    rows      token rows per CTA (64 = four windows, one warpgroup);
    resident  LN1(x) is made in the kernel and kept in shared memory
              (C <= 1,024), else made by a pass of its own and streamed;
    hs        heads per split: all of them where the row tiles fill the
              card or C < 384, else fewer for about one CTA per SM; at most
              what fits one block's shared memory beside y and the ring,
              and more again while the partial sums exceed ``PARTIAL_CAP``;
    splits    ceil(nh / hs) >= 1; above 1 the splits' fp32 partial sums
              (splits, T, C) are added in split order by a second launch
              (``sum_launch``);
    stages    ring stages of the weight stream: 4, or 3 where that lets one
              more block share the SM (C = 96: three) or only 3 fit;
    smem      :func:`plan_smem`, at most ``SMEM_MAX``.  The C entry point
              recomputes it and refuses a plan that differs."""
    row_tiles = -(-T // _ROWS)
    hs_fit = min(nh, 2 * ((SMEM_MAX - plan_smem(C, 0, 3)) // _SUB))
    min_splits = -(-nh // hs_fit)
    want = min(nh, NUM_SMS // row_tiles) if C >= _SPLIT_C else 1
    hs = -(-nh // max(min_splits, want))
    while (-(-nh // hs) > min_splits
           and -(-nh // hs) * T * C * 4 > PARTIAL_CAP):
        hs += 1
    splits = -(-nh // hs)
    per_sm = lambda stages: SM_SMEM // (plan_smem(C, hs, stages) + 1024)
    stages = 4 if per_sm(4) >= max(per_sm(3), 1) else 3
    return dict(rows=_ROWS, resident=C <= _RESIDENT_C, hs=hs, splits=splits,
                stages=stages, smem=plan_smem(C, hs, stages),
                sum_launch=splits > 1)


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


def _plan_args(x, T, C, nh, params):
    """(y scratch, partial sums, the plan's integers) of a launch: bf16
    under :func:`window_msa_plan`, fp32 under :func:`window_msa_plan_f32`
    (no y scratch: its rows stream through the ring)."""
    lnw, lnb, wqkv, bqkv, wproj, bproj = params
    for name, t in (("x", x), ("lnw", lnw), ("lnb", lnb), ("wqkv", wqkv),
                    ("bqkv", bqkv), ("wproj", wproj), ("bproj", bproj)):
        build.require_aligned(name, t)
    y = partial = None
    if x.dtype == torch.bfloat16:
        plan = window_msa_plan(T, C, nh)
    else:
        plan = dict(window_msa_plan_f32(T, C, nh), resident=True)
    if not plan["resident"]:
        y = torch.empty((T, C), device=x.device, dtype=x.dtype)
    if plan["sum_launch"]:
        partial = torch.empty((plan["splits"], T, C), device=x.device,
                              dtype=torch.float32)
    return y, partial, (plan["hs"], plan["splits"], plan["stages"],
                        plan["smem"])


def _launch(x, B, H, W, C, params, bias, mask, window, shift, eps, what):
    """tulip_window_msa on x read as a (B, H, W, C) grid."""
    wh, ww = window
    nh = bias.shape[0]
    if H % wh or W % ww:
        raise NotImplementedError(f"{what}: grid {H}x{W} is not a multiple "
                                  f"of window {window}")
    _check(x, C, nh, wh * ww, params, bias, mask, (H // wh) * (W // ww))
    y, partial, plan = _plan_args(x, B * H * W, C, nh, params)
    lib = build.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tulip_window_msa(
            build.dtype_code(x), x.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in params), bias.data_ptr(),
            build.ptr(mask), build.ptr(y), build.ptr(partial), B, H, W, C,
            nh, wh, ww, shift[0], shift[1], float((C // nh) ** -0.5),
            float(eps), *plan, stream)
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
    y, partial, plan = _plan_args(xg, n * L, C, nh, params)
    lib = build.load()
    out = torch.empty_like(xg)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = lib.tulip_window_msa_grouped(
            build.dtype_code(xg), xg.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in params), bias.data_ptr(),
            build.ptr(mask), build.ptr(y), build.ptr(partial), n, nW, C, nh,
            float((C // nh) ** -0.5), float(eps), *plan, stream)
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
