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
the kernel, both under the launch plan :func:`attn_core_plan` (tiles of
a few windows and a group of heads, one warp per window and head on
``mma.sync``): bf16 runs ``attn_fwd_tc_kernel`` / ``attn_bwd_tc_kernel``
(bf16 products, fp32 sums), fp32 ``attn_fwd_tf32_kernel`` /
``attn_bwd_tf32_kernel`` (split TF32: fp32-accurate products on the
tensor cores).
"""

from __future__ import annotations

import torch

from . import build
from .mlp import NUM_SMS
from .reduce import colsum
from .window_msa import SM_SMEM
from ..models.layers import wide
from ..parallel.halo import roll_hw

# windows of 16 tokens a tile and heads a group, at most, by element size:
# bf16 kAttnWin, kAttnMaxGroup; fp32 kAttnF32Win, kAttnF32Group.  fp32
# rows are twice as long, so its tile is half as tall: two windows of three
# heads, 75 KB forward (three blocks an SM) and 99 KB backward (two).  Of
# seven shapes timed, groups of three heads are 7-20 % faster than smaller
# ones, and two windows tie with one (PERF.md, section 6)
_TILE_WINDOWS = {2: 4, 4: 2}
_MAX_GROUP = {2: 3, 4: 3}


def _smem(esz: int, parts: int, hg: int) -> int:
    """Two tiles of 16 win rows of hg heads' parts of 32 elements, 16 bytes
    of pad a row (csrc attn_smem)."""
    return 2 * 16 * _TILE_WINDOWS[esz] * (hg * parts * 32 * esz + 16)


def attn_core_plan(T: int, C: int, nh: int, backward: bool,
                   esz: int = 2) -> dict:
    """Launch plan of the kernels (``csrc/attn_core.cu``
    attn_{fwd,bwd}_tc_kernel for esz 2, bf16; attn_{fwd,bwd}_tf32_kernel for
    esz 4, fp32), grid (ctas, groups), from the shape alone (T tokens of C
    = 32 nh channels):

    windows       T / 16 windows of 16 tokens over the batch;
    tile_windows  windows a tile (win): bf16 4, fp32 2;
    tiles         ceil(windows / win): 16 win token rows each, the last one
                  short where win does not divide the windows;
    hg            heads per group: the largest divisor of nh up to 3; a CTA
                  has 32 win hg threads, one warp per window and head of a
                  tile, and keeps its group for its whole walk;
    groups        nh / hg, along grid.y;
    per_sm        blocks an SM holds at once: those the kernel is built for
                  (bf16 two of 384 threads; fp32 what shared memory holds,
                  three forward and two backward at hg 3), more where the
                  group is smaller;
    ctas          CTAs along the tiles (grid.x): per_sm on every SM over
                  the groups, no second wave, at most the tiles; CTA x walks
                  tiles x, x + ctas, ...;
    smem          two tiles of 16 win rows of 32 esz hg parts + 16 bytes
                  (parts q, k, v and, backward, dO); the C entry point
                  recomputes it and refuses a plan that differs;
    part          the backward's fp32 d(bias) partials, one row of nh 16 x
                  16 per CTA along the tiles: what ``colsum`` adds in CTA
                  order."""
    windows = T // 16
    win = _TILE_WINDOWS[esz]
    tiles = -(-windows // win)
    hg = next(d for d in range(_MAX_GROUP[esz], 0, -1) if nh % d == 0)
    threads = 32 * win * hg
    parts = 4 if backward else 3
    smem = _smem(esz, parts, hg)
    # the launch bounds' blocks an SM at the largest group: bf16 two of 384
    # threads; fp32 as many as shared memory holds
    bound = (2 if esz == 2 else
             SM_SMEM // (_smem(esz, parts, _MAX_GROUP[esz]) + 1024))
    per_sm = min(SM_SMEM // (smem + 1024), bound * _MAX_GROUP[esz] // hg)
    groups = nh // hg
    ctas = min(tiles, max(1, per_sm * NUM_SMS // groups))
    return dict(windows=windows, tile_windows=win, tiles=tiles, hg=hg,
                groups=groups, threads=threads, ctas=ctas, smem=smem,
                per_sm=per_sm, part=(ctas, nh * 256))


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
    build.dtype_code(qkv)   # fp32 or bf16 (the plan's element size)
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
    build.require_aligned("qkv", qkv)
    out = torch.empty((B, H, W, C), device=qkv.device, dtype=qkv.dtype)
    p = attn_core_plan(B * H * W, C, nh, backward=False,
                       esz=qkv.element_size())
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
    """Backward (K9): d(bias) partials from the kernel (one row per CTA
    along the tiles), summed by ``tulip_colsum``.  Arguments as in
    :func:`attn_core_bwd_ref`."""
    if qkv.device.type == "cpu":
        return attn_core_bwd_ref(qkv, bias, mask, dout, window=window,
                                 shift=shift)
    if qkv.device.type != "cuda":
        raise build.not_cuda(qkv)
    B, H, W, C, nh = _check(qkv, bias, mask, window, "attn_core backward")
    build.require(dout, "dout", qkv.device, qkv.dtype, (B, H, W, C))
    build.require_aligned("qkv", qkv)
    build.require_aligned("dout", dout)
    p = attn_core_plan(B * H * W, C, nh, backward=True,
                       esz=qkv.element_size())
    nsplit, hg, smem = p["ctas"], p["hg"], p["smem"]
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
