"""Exact nearest-neighbour squared distances, min_j |a_i - b_j|^2, for the
chamfer metric, and the chamfer impl registry.

Replaces tulip_tpu/ops/chamfer.py (``min_sq_dists_xla``), the Pallas
kernels tulip_tpu/ops/pallas/chamfer.py ``_kernel`` (K7, brute force) and
chamfer_h.py ``_kernel_h2`` (K5, both directions over a list of tile pairs
built on the device) and ``_kernel_h`` (K6, one direction: K5's machinery
with the row halves only), and the registry of
tulip_tpu/ops/__init__.py.  The kernels are in ``csrc/chamfer.cu``.

Every wrapper takes the plain version (:func:`min_sq_dists_plain`, the
same minimum without skipping) for a CPU tensor and launches its kernel for
a CUDA tensor; any other device raises.  All forms compute the direct
difference dx^2 + dy^2 + dz^2 in fp32, so kernel and plain agree to
rounding.  a: (N, 3); b: (M, 3) with M a multiple of ``chunk`` (callers pad
with 1e8 sentinels, ``tulip_tpu.eval.metrics._PAD_VALUE``); N is free.

Registry names are the JAX package's: ``xla`` is the plain version,
``pallas`` K7, ``pallas_h`` K6 with ``.pair`` = K5, ``auto`` = ``pallas_h``
(or ``$TULIP_TPU_CHAMFER``).  ``preferred_chunk`` (1024 for pallas_h, 4096
otherwise) decides the callers' padding and the ``P % chunk`` branch.
"""

from __future__ import annotations

import os

import torch

from . import build

_PLAIN_ROWS = 16384     # query rows per step of the plain version
_BOUND_SLACK = 1e-3     # m, absorbs fp32 rounding in bounds and distances


def min_sq_dists_plain(a, b, chunk: int = 4096):
    """Plain version: a chunked loop over b (and over blocks of a rows, to
    bound memory) carrying a running min of the direct-form distances."""
    if b.shape[0] % chunk:
        raise ValueError(f"M={b.shape[0]} is not a multiple of "
                         f"chunk={chunk}")
    return _min_sq_dists(a, b, chunk)


def _min_sq_dists(a, b, chunk):
    a = a.float()
    b = b.float()
    N, M = a.shape[0], b.shape[0]
    out = torch.empty(N, device=a.device, dtype=torch.float32)
    for r0 in range(0, N, _PLAIN_ROWS):
        ax, ay, az = a[r0:r0 + _PLAIN_ROWS].unbind(1)
        best = torch.full((ax.shape[0],), 1e30, device=a.device)
        for c0 in range(0, M, chunk):
            bx, by, bz = b[c0:c0 + chunk].unbind(1)
            d = ((ax[:, None] - bx) ** 2 + (ay[:, None] - by) ** 2
                 + (az[:, None] - bz) ** 2)
            best = torch.minimum(best, d.amin(1))
        out[r0:r0 + _PLAIN_ROWS] = best
    return out


def _check(a, b, chunk):
    dev = a.device
    N, M = a.shape[0], b.shape[0]
    if M % chunk or chunk % 32:
        raise ValueError(f"kernels take chunk % 32 == 0 and M % chunk == 0; "
                         f"got M={M}, chunk={chunk}")
    if N == 0:
        raise ValueError("a has no points")
    build.require(a, "a", dev, torch.float32, (N, 3))
    build.require(b, "b", dev, torch.float32, (M, 3))


def _launch(fn, *args):
    lib = build.load()
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*[x.data_ptr() if torch.is_tensor(x) else x
                                 for x in args], stream)
    build.check(lib, err, fn)


def min_sq_dists_brute(a, b, chunk: int = 4096):
    """K7: min_j |a_i - b_j|^2 over every chunk of b."""
    if a.device.type == "cpu":
        return min_sq_dists_plain(a, b, chunk)
    if a.device.type != "cuda":
        raise build.not_cuda(a)
    a, b = a.float().contiguous(), b.float().contiguous()
    _check(a, b, chunk)
    out = torch.empty(a.shape[0], device=a.device, dtype=torch.float32)
    _launch("tulip_nn_brute", a, b, out, a.shape[0], b.shape[0], chunk)
    min_sq_dists_brute.launches += 1
    return out


min_sq_dists_brute.launches = 0


# ---------------------------------------------------------------------------
# The plain versions of K5's plan (chamfer_h.py:39-59, 108-162, 196-202,
# 264-311), plain torch on the tensors' device.
# ---------------------------------------------------------------------------

def _morton10(x, lo, span):
    """10-bit-per-axis 3-D Morton codes (int64) for (N, 3) fp32 points."""
    q = torch.clamp(((x - lo) / span) * 1023.0, 0.0, 1023.0).to(torch.int64)

    def part1by2(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1)
            | (part1by2(q[:, 2]) << 2))


def _real_box(x):
    """Bounding box of the points that are not 1e8 sentinels."""
    real = (x.abs() < 1e7).all(dim=-1, keepdim=True)
    inf = torch.tensor(float("inf"), device=x.device)
    lo = torch.where(real, x, inf).amin(0)
    hi = torch.where(real, x, -inf).amax(0)
    return lo, hi


def _morton_order(a, b):
    """Stable Morton argsorts of a and b over the joint box of their real
    points (the sentinels would otherwise stretch the box so that every real
    point falls in one cell; they clip to the last cell and sort last)."""
    lo_a, hi_a = _real_box(a)
    lo_b, hi_b = _real_box(b)
    lo = torch.minimum(lo_a, lo_b)
    span = torch.clamp(torch.maximum(hi_a, hi_b) - lo, min=1e-6)
    return (torch.argsort(_morton10(a, lo, span), stable=True),
            torch.argsort(_morton10(b, lo, span), stable=True))


def _tiles(pts, tile):
    """(T, tile, 3) view of pts; a ragged last tile is filled with copies of
    the last point, which leave its box valid."""
    pad = (-pts.shape[0]) % tile
    if pad:
        pts = torch.cat([pts, pts[-1:].expand(pad, 3)])
    return pts.reshape(-1, tile, 3)


def _tile_boxes(pts, tile):
    """AABB centers (T, 3) and half-extents (T, 3) of each tile
    (chamfer_h.py:_tile_boxes)."""
    t = _tiles(pts, tile)
    lo = t.amin(1)
    hi = t.amax(1)
    return 0.5 * (lo + hi), 0.5 * (hi - lo)


def box_gap2_table(ca, ha, cb, hb):
    """Squared norm (Ti, Tj) of the per-axis gaps between query box i and
    target box j (centers c, half-extents h), in the operations and order of
    csrc/chamfer.cu:box_gap2."""
    gap = torch.clamp((ca[:, None, :] - cb[None, :, :]).abs()
                      - ha[:, None, :] - hb[None, :, :], min=0.0)
    sq = gap * gap
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def box_lb_table(ca, ha, cb, hb):
    """Squared lower bound (Ti, Tj) on the distance between a point of
    query box i and one of target box j: the norm of the per-axis gaps less
    1e-3 m of slack, squared (chamfer_h.py's box bound)."""
    return _lb_of(box_gap2_table(ca, ha, cb, hb))


def _lb_of(s):
    """(sqrt(s) - 1e-3 m)^2, floored at 0: the bound of a squared gap s."""
    lin = torch.clamp(torch.sqrt(s) - _BOUND_SLACK, min=0.0)
    return lin * lin


def h2_s_threshold(t):
    """The least s >= 0 with _lb_of(s) >= t (0 where t <= 0), elementwise:
    for s >= 0, _lb_of(s) < t exactly when s < h2_s_threshold(t), since
    _lb_of is monotone.  The kernels test squared gaps against these
    (csrc/chamfer.cu:s_threshold, the same binary search over the bits of
    s) and take no square root in their loops."""
    t = t.float()
    lo = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    hi = torch.full_like(lo, 0x7f800000)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        ok = _lb_of(mid.view(torch.float32)) >= t
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    return torch.where(t > 0, hi.view(torch.float32), torch.zeros_like(t))


def _box_lb(a_s, b_s, tile, chunk):
    return box_lb_table(*_tile_boxes(a_s, tile), *_tile_boxes(b_s, chunk))


def plan(a, b, chunk, tile):
    """The JAX K5's box tables (min_sq_dists_pallas_h2), in plain torch:
    (pa, pb, a_s, b_s, lb_sorted, order).

    pa / pb sort a / b in Morton order; lb (ceil(N / tile), M / chunk) is
    the squared lower bound on the distance between query tile i of a_s and
    target chunk j of b_s (:func:`box_lb_table`), with 1e-3 m of slack
    before squaring; each row of ``order`` lists the chunks by ascending
    bound (stable, as jnp.argsort) and ``lb_sorted`` the bounds in that
    order."""
    pa, pb = _morton_order(a, b)
    a_s = a[pa].contiguous()
    b_s = b[pb].contiguous()
    lb = _box_lb(a_s, b_s, tile, chunk)
    order = torch.argsort(lb, dim=1, stable=True)
    lb_sorted = torch.take_along_dim(lb, order, dim=1).contiguous()
    return pa, pb, a_s, b_s, lb_sorted, order.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# K5's plan and its pair rounds (csrc/chamfer.cu, section "K5"), plain torch:
# the kernels' plain versions; the tests replay the rounds on the CPU, in
# both directions (K5) and in one (K6).
# ---------------------------------------------------------------------------

H2_ROWS = 128             # query points per tile (kRows: 4 per lane)
H2_COLS = 32              # target points per tile (kCols: 1 per lane)
H2_FRACS = (1 / 64, 1 / 8, 1.0)   # the rounds after the first: lb < f ub
H2_WIDE = 1e6             # m: a half-extent this wide mixes in sentinels
_H2_BOX_BLOCKS = 264      # blocks of the box and code kernels (kBoxBlocks)


def h2_sizes(N, M, what="K5"):
    """(query tiles, target tiles, bitmap words per row) of K5 (and K6);
    raises where the kernels' int32 pair index cannot hold the tile pairs
    (beyond about 2.9M points a side)."""
    if M % H2_COLS:
        raise ValueError(f"M={M} is not a multiple of {H2_COLS}")
    Ti, Tj = -(-N // H2_ROWS), M // H2_COLS
    if Ti * Tj >= 2 ** 31:
        raise ValueError(f"{what} takes fewer than 2^31 tile pairs; got "
                         f"N={N}, M={M}")
    return Ti, Tj, -(-Tj // 32)


def h2_boxes(pts, tile):
    """The kernels' tile boxes: :func:`_tile_boxes`, with an infinite
    half-extent on every axis of a tile wider than H2_WIDE on one.  Such a
    tile mixes real points with 1e8 sentinels; at ~5e7 m fp32 rounds its
    edges by up to 8 m, beyond the bound's 1e-3 m of slack, and the
    infinite extent bounds it by 0 against every tile instead."""
    c, h = _tile_boxes(pts, tile)
    wide = (h > H2_WIDE).any(1, keepdim=True)
    return c, torch.where(wide, torch.full_like(h, float("inf")), h)


def h2_plan(a, b):
    """(pa, pb, a_s, b_s, (ca, ha), (cb, hb)): the Morton orders, the sorted
    clouds and the boxes (:func:`h2_boxes`) of their H2_ROWS / H2_COLS
    tiles; the plain version of :func:`_h2_device_plan`."""
    pa, pb = _morton_order(a, b)
    a_s = a[pa].contiguous()
    b_s = b[pb].contiguous()
    return (pa, pb, a_s, b_s, h2_boxes(a_s, H2_ROWS), h2_boxes(b_s, H2_COLS))


def h2_first_pairs(lb, both=True):
    """Round 0: every tile pair at its row's smallest bound (all ties), so
    every query gets a true partial minimum; with ``both`` (K5) also every
    pair at its column's, so every target does too."""
    first = lb == lb.amin(1, keepdim=True)
    return first | (lb == lb.amin(0, keepdim=True)) if both else first


def _tile_max(d, tile):
    pad = (-d.shape[0]) % tile
    if pad:
        d = torch.cat([d, d[-1:].expand(pad)])
    return d.reshape(-1, tile).amax(1)


def h2_upper_bounds(d_a, d_b=None):
    """(ub_a, ub_b): each tile's largest current minimum (ub_b None in one
    direction); a minimum only falls, so each bounds its tile's final
    minima from above."""
    return (_tile_max(d_a, H2_ROWS),
            None if d_b is None else _tile_max(d_b, H2_COLS))


def h2_round_pairs(lb, ub_a, ub_b, frac, done):
    """A later round: the pairs of no earlier round whose bound is below
    frac times the row's upper bound or (K5; ub_b None for K6) the
    column's.  After the round with frac = 1 every pair left out has lb >=
    the bounds, so none of its distances is below a final minimum of its
    rows (and columns): the result is exact."""
    sel = lb < frac * ub_a[:, None]
    if ub_b is not None:
        sel = sel | (lb < frac * ub_b[None, :])
    return sel & ~done


def min_sq_dists_h2_plain(a, b, chunk: int = 1024):
    """Plain version of K5: both directions by brute force.  Unlike the
    JAX kernel, which pads a ragged ``a`` with sentinels that then appear in
    the column minima, the b-direction minimum runs over a's N rows only."""
    return min_sq_dists_plain(a, b, chunk), _min_sq_dists(b, a, chunk)


def _h2_buffers(N, M, device, both=True):
    """The scratch of K5 (``both``) or of K6, carved from one fp32 and one
    int32 allocation, and the per-round counts.  K6 has no column
    thresholds, word maxima or column minima: thr holds Ti floats, and
    wmax and sb are left out."""
    Ti, Tj, W = h2_sizes(N, M, "K5" if both else "K6")
    T = Ti + Tj
    f = dict(partial=6 * _H2_BOX_BLOCKS, boxes=6 * T, thr=T if both else Ti,
             wmax=W, smin=Ti * W, a_s=3 * N, b_s=3 * M, sa=N, sb=M)
    if not both:
        del f["wmax"], f["sb"]
    fs = torch.empty(sum(f.values()), device=device).split(list(f.values()))
    i = dict(codes=N + M, done=Ti * W, list=Ti * Tj)
    is_ = torch.empty(sum(i.values()), device=device,
                      dtype=torch.int32).split(list(i.values()))
    # the counts on their own: the wrapper keeps them after the call
    counts = torch.empty(2 * (1 + len(H2_FRACS)), device=device,
                         dtype=torch.int32)
    return dict(zip(f, fs), **dict(zip(i, is_)), counts=counts)


def _h2_device_plan(a, b, buf):
    """K5's plan on the card: Morton codes (nn2_box_kernel,
    nn2_morton_kernel), one stable argsort of both clouds' codes (b's
    tagged with bit 30), then the sorted clouds and tile boxes
    (nn2_gather_kernel) into buf.  Returns perm: pa = perm[:N], pb =
    perm[N:] - N, the orders of :func:`h2_plan`."""
    N, M = a.shape[0], b.shape[0]
    _launch("tulip_nn_h2_codes", a, b, buf["partial"], buf["codes"], N, M)
    perm = torch.argsort(buf["codes"], stable=True)
    _launch("tulip_nn_h2_gather", a, b, perm, buf["a_s"], buf["b_s"],
            buf["boxes"], N, M)
    return perm


def min_sq_dists_h2(a, b, chunk: int = 1024):
    """K5: (min_j |a_i - b_j|^2 over i, min_i |a_i - b_j|^2 over j), exact,
    over the tile pairs the rounds of :func:`h2_round_pairs` list.  Three C
    calls and one argsort: the plan (:func:`_h2_device_plan`), then the
    bound, list and sweep kernels, which keep the pair counts on the device
    (no host synchronisation).  ``chunk`` is the callers' padding granule:
    M must be a multiple of it; the kernel's own tiles are H2_ROWS x
    H2_COLS."""
    if a.device.type == "cpu":
        return min_sq_dists_h2_plain(a, b, chunk)
    if a.device.type != "cuda":
        raise build.not_cuda(a)
    a, b = a.float().contiguous(), b.float().contiguous()
    _check(a, b, chunk)
    N, M = a.shape[0], b.shape[0]
    buf = _h2_buffers(N, M, a.device)
    perm = _h2_device_plan(a, b, buf)
    out_a = torch.empty(N, device=a.device, dtype=torch.float32)
    out_b = torch.empty(M, device=a.device, dtype=torch.float32)
    _launch("tulip_nn_h2", buf["a_s"], buf["b_s"], buf["boxes"], perm,
            buf["thr"], buf["wmax"], buf["smin"], buf["sa"], buf["sb"],
            buf["counts"], buf["done"], buf["list"], out_a, out_b, N, M)
    min_sq_dists_h2.launches += 1
    # (pairs listed, items taken) per round; a diagnostic that only a
    # caller reads, after its own synchronisation
    min_sq_dists_h2.last_counts = buf["counts"]
    return out_a, out_b


min_sq_dists_h2.launches = 0
min_sq_dists_h2.last_counts = None


def min_sq_dists_h(a, b, chunk: int = 1024):
    """K6: min_j |a_i - b_j|^2, exact: K5's plan, then the one-direction
    bound, list and sweep kernels (rows only: :func:`h2_first_pairs` with
    ``both=False``, :func:`h2_round_pairs` without column bounds), with the
    pair counts on the device (no host synchronisation).  ``chunk`` is the
    callers' padding granule: M must be a multiple of it.  Unlike the TPU
    kernel it takes fewer than 2^31 tile pairs of 128 x 32 points (about
    2.9M points a side; :func:`h2_sizes` raises beyond)."""
    if a.device.type == "cpu":
        return min_sq_dists_plain(a, b, chunk)
    if a.device.type != "cuda":
        raise build.not_cuda(a)
    a, b = a.float().contiguous(), b.float().contiguous()
    _check(a, b, chunk)
    N, M = a.shape[0], b.shape[0]
    buf = _h2_buffers(N, M, a.device, both=False)
    perm = _h2_device_plan(a, b, buf)
    out = torch.empty(N, device=a.device, dtype=torch.float32)
    _launch("tulip_nn_h1", buf["a_s"], buf["b_s"], buf["boxes"], perm,
            buf["thr"], buf["smin"], buf["sa"], buf["counts"], buf["done"],
            buf["list"], out, N, M)
    min_sq_dists_h.launches += 1
    # (pairs listed, items taken) per round, as K5's
    min_sq_dists_h.last_counts = buf["counts"]
    return out


min_sq_dists_h.launches = 0
min_sq_dists_h.last_counts = None
min_sq_dists_h.preferred_chunk = 1024
min_sq_dists_h.pair = min_sq_dists_h2
min_sq_dists_h2.preferred_chunk = 1024

# ---------------------------------------------------------------------------
# Registry (tulip_tpu/ops/__init__.py)
# ---------------------------------------------------------------------------

_CHAMFER_IMPLS = {"xla": min_sq_dists_plain, "pallas": min_sq_dists_brute,
                  "pallas_h": min_sq_dists_h}
_DEFAULT_CHAMFER = "auto"


def set_default_chamfer_impl(name: str) -> None:
    """Wire the --chamfer_impl flag (auto | xla | pallas | pallas_h)."""
    global _DEFAULT_CHAMFER
    if name != "auto" and name not in _CHAMFER_IMPLS:
        raise ValueError(f"unknown chamfer impl {name!r}")
    _DEFAULT_CHAMFER = name


def get_chamfer_impl(name: str | None = None):
    """The impl for ``name``, or the default: ``auto`` resolves to
    ``$TULIP_TPU_CHAMFER`` if set, else ``pallas_h``."""
    if name is None:
        name = _DEFAULT_CHAMFER
    if name == "auto":
        name = os.environ.get("TULIP_TPU_CHAMFER") or "pallas_h"
    if name not in _CHAMFER_IMPLS:
        raise ValueError(f"unknown chamfer impl {name!r}")
    return _CHAMFER_IMPLS[name]
