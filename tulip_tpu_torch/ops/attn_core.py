"""Window attention core of the training path, forward and backward.

Replaces the Pallas kernels tulip_tpu/ops/pallas/attn_core.py
``_fwd_kernel`` (K8, :func:`attn_core_fwd`) and ``_bwd_kernel`` (K9,
:func:`attn_core_bwd`) with the CUDA kernels of ``csrc/attn_core.cu``;
:class:`AttnCore` joins them as a ``torch.autograd.Function``.  Per
(wh, ww) window of the grid rolled by ``-shift``, and head h:

    o_h = softmax(q_h k_h^T * scale + B_h [+ M_win]) v_h

from the fused projection qkv (B, H, W, 3C) = [q | k | v], written back to
the tokens' own (unrolled) positions.  B (nh, L, L) fp32 is the gathered
relative-position bias and is differentiable; M (nW, L, L) fp32 is the
constant 0/-100 shift mask.  The LN, the qkv and output projections stay
plain ``F.linear`` around it, as they were XLA GEMMs around the TPU core.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
a kernel for a CUDA tensor; any other device raises.  The dtype decides
the kernel: bf16 runs ``attn_fwd_tc_kernel`` / ``attn_bwd_tc_kernel``
(tiles of four windows and a group of heads, one warp per window and head
on ``mma.sync``) under the launch plan :func:`attn_core_plan`; fp32 runs
``attn_fwd_kernel`` / ``attn_bwd_kernel``, the FMA kernels of the parity
path.
"""

from __future__ import annotations

import torch

from . import build
from .mlp import NUM_SMS
from .reduce import colsum
from .window_msa import SM_SMEM
from ..models.layers import wide
from ..parallel.halo import roll_hw

_BWD_BLOCKS = 2048   # CTAs of the fp32 backward: heads x window splits
_TILE_WINDOWS = 4    # windows of 16 tokens per tile (csrc kAttnWin)
_MAX_GROUP = 3       # heads per group, at most (kAttnMaxGroup)
# registers a thread may take: the kernels are built for two CTAs of 384
# threads per SM (__launch_bounds__(384, 2)) out of the SM's 65,536
_REG_CAP = 65536 // (2 * 32 * _TILE_WINDOWS * _MAX_GROUP)


def attn_core_plan(T: int, C: int, nh: int, backward: bool) -> dict:
    """Launch plan of the bf16 kernels (``csrc/attn_core.cu``
    attn_fwd_tc_kernel, attn_bwd_tc_kernel), grid (ctas, groups), from the
    shape alone (T tokens of C = 32 nh channels):

    windows  T / 16 windows of 16 tokens over the batch;
    tiles    ceil(windows / 4): 64 token rows each, the last one short
             where 4 does not divide the windows;
    hg       heads per group: the largest of 3, 2, 1 that divides nh; a
             CTA has 128 hg threads, one warp per window and head of a
             tile, and keeps its group for its whole walk;
    groups   nh / hg, along grid.y;
    ctas     CTAs along the tiles (grid.x): as many as the SMs hold at
             once (shared memory, registers) over the groups, at most the
             tiles; CTA x walks tiles x, x + ctas, x + 2 ctas, ...;
    smem     two tiles of 64 rows of 64 hg parts + 16 bytes (parts q, k, v
             and, backward, dO); the C entry point recomputes it and
             refuses a plan that differs;
    part     the backward's fp32 d(bias) partials, one row of nh 16 x 16
             per CTA along the tiles: what ``colsum`` adds in CTA order."""
    windows = T // 16
    tiles = -(-windows // _TILE_WINDOWS)
    hg = next(d for d in range(_MAX_GROUP, 0, -1) if nh % d == 0)
    threads = 32 * _TILE_WINDOWS * hg
    parts = 4 if backward else 3
    smem = 2 * 16 * _TILE_WINDOWS * (64 * hg * parts + 16)
    per_sm = min(SM_SMEM // (smem + 1024), 65536 // (threads * _REG_CAP))
    groups = nh // hg
    ctas = min(tiles, -(-(per_sm * NUM_SMS) // groups))
    return dict(windows=windows, tiles=tiles, hg=hg, groups=groups,
                threads=threads, ctas=ctas, smem=smem,
                part=(ctas, nh * 256))


def _windows(t, window, shift):
    """(B, H, W, X) -> (B * nW, L, X): the windows of t rolled by -shift."""
    B, H, W, X = t.shape
    wh, ww = window
    t = roll_hw(t, -shift[0], -shift[1])
    return (t.reshape(B, H // wh, wh, W // ww, ww, X)
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, X))


def _unwindows(t, shape, window, shift):
    """Inverse of :func:`_windows`."""
    B, H, W, X = shape
    wh, ww = window
    t = (t.reshape(B, H // wh, W // ww, wh, ww, X)
         .permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, X))
    return roll_hw(t, shift[0], shift[1])


def _split_heads(t, n, nh):
    """(Bn, L, n * C) -> n tensors (Bn, nh, L, C / nh)."""
    Bn, L, X = t.shape
    t = t.reshape(Bn, L, n, nh, X // (n * nh))
    return t.permute(2, 0, 3, 1, 4).unbind(0)


def _probs(q, k, bias, mask, scale):
    """fp32 (float64 for float64 inputs) softmax of the window logits."""
    s = wide(q) @ wide(k).transpose(-1, -2) * scale + wide(bias)
    if mask is not None:
        Bn, nh, L, _ = s.shape
        nW = mask.shape[0]
        s = (s.reshape(Bn // nW, nW, nh, L, L)
             + wide(mask)[None, :, None]).reshape(Bn, nh, L, L)
    return torch.softmax(s, dim=-1)


def attn_core_ref(qkv, bias, mask, *, window, shift):
    """Plain forward.  qkv (B, H, W, 3C); bias (nh, L, L); mask (nW, L, L)
    or None.  Logits and softmax fp32; the probabilities are rounded to
    qkv's dtype before PV, as in the kernel."""
    B, H, W, C3 = qkv.shape
    nh = bias.shape[0]
    q, k, v = _split_heads(_windows(qkv, window, shift), 3, nh)
    scale = (C3 // 3 // nh) ** -0.5
    p = _probs(q, k, bias, mask, scale).to(qkv.dtype)
    o = (p @ v).transpose(1, 2).reshape(q.shape[0], -1, C3 // 3)
    return _unwindows(o, (B, H, W, C3 // 3), window, shift)


def attn_core_bwd_ref(qkv, bias, mask, dout, *, window, shift):
    """Plain backward, written out (P recomputed): dout (B, H, W, C) ->
    (dqkv (B, H, W, 3C) in qkv's dtype, dbias (nh, L, L) in bias's dtype).
    P is rounded to qkv's dtype for dv, dS for dq / dk; dbias sums the
    unrounded dS over every window of the batch."""
    B, H, W, C3 = qkv.shape
    nh = bias.shape[0]
    d = qkv.dtype
    q, k, v = _split_heads(_windows(qkv, window, shift), 3, nh)
    (do,) = _split_heads(_windows(dout, window, shift), 1, nh)
    scale = (C3 // 3 // nh) ** -0.5
    p32 = _probs(q, k, bias, mask, scale)
    dv = wide(p32.to(d)).transpose(-1, -2) @ wide(do)
    t = p32 * (wide(do) @ wide(v).transpose(-1, -2))
    ds = t - p32 * t.sum(-1, keepdim=True)
    dsd = wide(ds.to(d))
    dq = dsd @ wide(k) * scale
    dk = dsd.transpose(-1, -2) @ wide(q) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    dqkv = dqkv.reshape(q.shape[0], -1, C3).to(d)
    return (_unwindows(dqkv, (B, H, W, C3), window, shift),
            ds.sum(0).to(bias.dtype))


def _check(qkv, bias, mask, window, what):
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    nh = bias.shape[0]
    wh, ww = window
    if wh * ww != 16 or C != 32 * nh or H % wh or W % ww:
        raise NotImplementedError(
            f"{what} kernel takes 16-token windows and head dim 32; got "
            f"window {window}, C={C}, heads={nh}, grid {H}x{W}")
    dev = qkv.device
    build.require(qkv, "qkv", dev, qkv.dtype, (B, H, W, C3))
    build.require(bias, "bias", dev, torch.float32, (nh, 16, 16))
    if mask is not None:
        build.require(mask, "mask", dev, torch.float32,
                      ((H // wh) * (W // ww), 16, 16))
    return B, H, W, C, nh


def attn_core_fwd(qkv, bias, mask, *, window, shift):
    """Forward (K8).  Arguments as in :func:`attn_core_ref`."""
    if qkv.device.type == "cpu":
        return attn_core_ref(qkv, bias, mask, window=window, shift=shift)
    if qkv.device.type != "cuda":
        raise build.not_cuda(qkv)
    B, H, W, C, nh = _check(qkv, bias, mask, window, "attn_core")
    out = torch.empty((B, H, W, C), device=qkv.device, dtype=qkv.dtype)
    plan = (0, 0, 0)   # the fp32 kernel takes none
    if qkv.dtype == torch.bfloat16:
        build.require_aligned("qkv", qkv)
        p = attn_core_plan(B * H * W, C, nh, backward=False)
        plan = (p["ctas"], p["hg"], p["smem"])
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tulip_attn_fwd(
            build.dtype_code(qkv), qkv.data_ptr(), out.data_ptr(),
            bias.data_ptr(), build.ptr(mask), B, H, W, C, nh, *window,
            *shift, *plan, float((C // nh) ** -0.5), stream)
    build.check(lib, err, "attn_core")
    attn_core_fwd.launches += 1
    return out


attn_core_fwd.launches = 0


def attn_core_bwd(qkv, bias, mask, dout, *, window, shift):
    """Backward (K9): d(bias) partials from the kernel (one row per window
    split in fp32, per CTA along the tiles in bf16), summed by
    ``tulip_colsum``.  Arguments as in :func:`attn_core_bwd_ref`."""
    if qkv.device.type == "cpu":
        return attn_core_bwd_ref(qkv, bias, mask, dout, window=window,
                                 shift=shift)
    if qkv.device.type != "cuda":
        raise build.not_cuda(qkv)
    B, H, W, C, nh = _check(qkv, bias, mask, window, "attn_core backward")
    build.require(dout, "dout", qkv.device, qkv.dtype, (B, H, W, C))
    if qkv.dtype == torch.bfloat16:
        build.require_aligned("qkv", qkv)
        build.require_aligned("dout", dout)
        p = attn_core_plan(B * H * W, C, nh, backward=True)
        nsplit, hg, smem = p["ctas"], p["hg"], p["smem"]
    else:
        windows = B * (H // window[0]) * (W // window[1])
        nsplit, hg, smem = max(1, min(windows, _BWD_BLOCKS // nh, 65535)), 0, 0
    dqkv = torch.empty_like(qkv)
    part = torch.empty((nsplit, nh * 256), device=qkv.device,
                       dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.tulip_attn_bwd(
            build.dtype_code(qkv), qkv.data_ptr(), dout.data_ptr(),
            dqkv.data_ptr(), bias.data_ptr(), build.ptr(mask),
            part.data_ptr(), B, H, W, C, nh, *window, *shift, nsplit, hg,
            smem, float((C // nh) ** -0.5), stream)
    build.check(lib, err, "attn_core backward")
    dbias = colsum(part).view(nh, 16, 16)
    attn_core_bwd.launches += 1
    return dqkv, dbias


attn_core_bwd.launches = 0


class AttnCore(torch.autograd.Function):
    """:func:`attn_core_fwd` (K8) with :func:`attn_core_bwd` (K9) as its
    backward; the probabilities are recomputed, never saved."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, window, shift):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.geom = dict(window=window, shift=shift)
        return attn_core_fwd(qkv, bias, mask, **ctx.geom)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = attn_core_bwd(qkv, bias, mask, dout.contiguous(),
                                    **ctx.geom)
        return dqkv, dbias, None, None, None


def attn_core(qkv, bias, mask, *, window, shift):
    """Differentiable attention core (arguments as in
    :func:`attn_core_ref`)."""
    return AttnCore.apply(qkv, bias, mask, tuple(window), tuple(shift))
