"""The launch plans and the arithmetic of the fp32 split-TF32 backward
kernels (csrc/mlp_bwd.cu for K10 / K11, csrc/reduce.cu
tn_gemm_tf32_kernel for their weight gradients), in plain Python and
numpy: no card is needed.

- The plans (ops/mlp.py:bwd_plan_f32, ops/reduce.py:tn_gemm_plan in fp32)
  fit the shared memory of three blocks an SM and cover every token row,
  hidden unit, output column and 32-deep tile once, at every shape of the
  batch-1 / 2 / 8 training step of TULIP-base and -large at 32 x 2048 (the
  MLPs, the folded head, the merges) and on W shards of --sp_degree 2 / 4.
- The token-pass plan reads the widths alone, so a token's dx is summed in
  one order at any token count.
- What the kernels add, in their order (dy's splits in split order, each
  32-deep tile's products folded into the split's total; tn_gemm's
  32-token slices folded, its splits summed in order) equals the plain
  backward in float64 (summation order only), and a 131,072-token
  contraction emulated in fp32 split TF32 holds fp32's accuracy."""

import numpy as np
import pytest
import torch

from tulip_tpu_torch.ops import mlp as TM
from tulip_tpu_torch.ops.reduce import tn_gemm_plan

SM_SMEM = 233472           # shared bytes of an SM; 1 KB kept per block
SMEM_MAX = 232448          # shared bytes a block can use on sm_90

# (tokens of one image, C) of each Swin stage at 32 x 2048
BASE = [(32 * 512, 96), (16 * 256, 192), (8 * 128, 384), (4 * 64, 768)]
LARGE = BASE + [(2 * 32, 1536)]


def _step_shapes():
    """(N, C, Hd, what) of every fp32 K10 (C, Hd = 4 C; the head: C 96,
    Hd 1,536) and K11 (K for C, O = K / 2 for Hd) launch of a training
    step of TULIP-base and -large at batch 1, 2, 8, in one process and on
    a W shard of --sp_degree 2 / 4."""
    out = set()
    for stages in (BASE, LARGE):
        for b in (1, 2, 8):
            for sp in (1, 2, 4):
                for t, c in stages:
                    out.add((t * b // sp, c, 4 * c, "mlp"))
                out.add((32 * 512 * b // sp, 96, 1536, "head"))
                for t, c in stages[:-1]:
                    out.add((t * b // 4 // sp, 4 * c, 2 * c, "merge"))
    return sorted(out)


@pytest.mark.parametrize("N,C,Hd,what", _step_shapes() + [
    (1000, 384, 200, "merge"), (64, 384, 8, "merge")])
def test_bwd_f32_plan_fits_and_covers(N, C, Hd, what):
    p = TM.bwd_plan_f32(N, C, Hd)
    assert p["rows"] == 64 and p["hid"] == 64 and p["bn"] == 64
    # 1 KB alignment room, the split buffer (a 64 x 32 fp32 tile as hi and
    # lo), three raw stages of two 32 x 72 fp32 slots: three blocks an SM
    assert p["smem"] == TM.SMEM_BWD_F32 == 1024 + 16384 + 3 * 2 * 9216
    assert 3 * (p["smem"] + 1024) <= SM_SMEM and p["smem"] <= SMEM_MAX
    # the hidden kernel: every row in one 64-row tile, every hidden unit in
    # one 64-unit tile
    rows = [r for t in range(-(-N // 64)) for r in range(64 * t,
                                                         min(N, 64 * t + 64))]
    assert rows == list(range(N))
    units = [u for t in range(-(-Hd // 64))
             for u in range(64 * t, min(Hd, 64 * t + 64))]
    assert units == list(range(Hd))
    # the dy kernel: every column of C in one 64-column tile, every 32-deep
    # tile of Hd in exactly one split (none empty), at most F32_DY_DEPTH a
    # split; split z runs min(kts, ceil(Hd / 32) - z kts) tiles from tile
    # z kts (dy_tile_f32), the last of them part zeros where 32 does not
    # divide Hd (K11's O: a multiple of 8)
    cols = [c for t in range(-(-C // 64)) for c in range(64 * t,
                                                         min(C, 64 * t + 64))]
    assert cols == list(range(C))
    kt, depth, splits = -(-Hd // 32), p["dy_depth"], p["dy_splits"]
    assert depth % 32 == 0 and depth <= TM.F32_DY_DEPTH
    assert splits == -(-Hd // depth)
    kts, tiles = depth // 32, []
    for z in range(splits):
        n = min(kts, kt - z * kts)
        assert n > 0
        tiles += range(z * kts, z * kts + n)
    assert tiles == list(range(kt))
    units_dy = [u for t in tiles for u in range(32 * t, min(Hd, 32 * t + 32))]
    assert units_dy == list(range(Hd))


@pytest.mark.parametrize("C,Hd", [(96, 384), (192, 768), (384, 1536),
                                  (768, 3072), (1536, 6144), (96, 1536),
                                  (384, 192), (768, 384), (1536, 768),
                                  (3072, 1536)])
def test_bwd_f32_plan_ignores_the_token_count(C, Hd):
    """The token count sets the row tiles and nothing else: a token's dx
    is summed in one order in a batch-1 call, a W shard, a data rank or a
    batch of eight."""
    plans = [TM.bwd_plan_f32(n, C, Hd) for n in (1, 64, 1000, 4096, 131072)]
    assert all(q == plans[0] for q in plans)
    assert plans[0]["dy_splits"] == -(-Hd // 768)


@pytest.mark.parametrize("N,C,Hd", [(256, 768, 3072), (1024, 384, 1536),
                                    (4096, 192, 768), (16384, 96, 1536)])
def test_bwd_f32_plan_fills_the_card_at_batch_1(N, C, Hd):
    """TULIP-base's batch-1 MLPs and head: the dy launch (row tiles x
    column tiles x splits) gives at least one CTA per SM."""
    p = TM.bwd_plan_f32(N, C, Hd)
    assert -(-N // 64) * -(-C // 64) * p["dy_splits"] >= TM.NUM_SMS


def _tn_shapes():
    """(T, M, N) of every fp32 tn_gemm of a training step (dW1 = dh^T y,
    dW2 = g^T a, dW = g^T y) of TULIP-base and -large at batch 1, 2, 8 and
    on W shards, plus ragged token counts."""
    out = {(1000, 384, 96), (77, 96, 384), (33, 16, 1536)}
    for n, c, hd, what in _step_shapes():
        if what == "merge":
            out.add((n, hd, c))
        else:
            out.add((n, hd, c))
            out.add((n, c if what == "mlp" else 16, hd))
    return sorted(out)


@pytest.mark.parametrize("T,M,N", _tn_shapes())
def test_tn_gemm_f32_plan_covers_tokens_once(T, M, N):
    splits, tps = tn_gemm_plan(T, M, N, torch.float32)
    assert tps % 32 == 0 and splits >= 1
    # split s owns tokens [s tps, min(T, (s + 1) tps)), none empty, every
    # token once; about eight blocks per SM of the 64 x 64 output tiles
    assert (splits - 1) * tps < T <= splits * tps
    tiles = -(-M // 64) * -(-N // 64)
    assert splits <= max(1, -(-1056 // tiles))


@pytest.mark.parametrize("N,C,Hd,res,ln", [
    (300, 768, 3072, True, True),      # stage 3: four dy splits
    (200, 384, 1536, True, True),      # stage 2: two
    (150, 96, 1536, False, True),      # the head's widths: two
    (100, 1536, 6144, True, False),    # TULIP-large's, no LN: eight
])
def test_bwd_f32_split_order_equals_plain_float64(N, C, Hd, res, ln):
    """What the fp32 token pass computes, in its order: dy of each split is
    the sum of its 32-deep tiles' products, each added to the split's total
    in tile order; the splits are added in split order by the finish
    kernel, then the LN backward and + g.  In float64 that equals the
    plain backward's dx to summation order (1e-12 of max|ref|)."""
    p = TM.bwd_plan_f32(N, C, Hd)
    assert p["dy_splits"] > 1
    rng = np.random.default_rng(N + C)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s))
    x, g = t(N, C), t(N, C)
    lnw, lnb = (t(C) * 0.1 + 1, t(C) * 0.1) if ln else (None, None)
    w1, b1, w2 = t(Hd, C) * C ** -0.5, t(Hd) * 0.1, t(C, Hd) * Hd ** -0.5
    y = x if lnw is None else TM.layer_norm(x, lnw, lnb, 1e-6)
    h = y @ w1.T + b1
    dh = (g @ w2) * TM._act_grad(h, "gelu")
    dy = torch.zeros(N, C, dtype=torch.float64)
    for s in range(p["dy_splits"]):                     # split order
        total = torch.zeros(N, C, dtype=torch.float64)
        for k in range(s * p["dy_depth"], min(Hd, (s + 1) * p["dy_depth"]),
                       32):                             # tile order
            total += dh[:, k:k + 32] @ w1[k:k + 32]
        dy += total
    if lnw is None:
        dx = dy
    else:
        xh, rstd = TM._ln_stats(x, 1e-6)
        dx = TM._ln_backward(dy, xh, rstd, lnw)[0]
    dx = dx + (g if res else 0)
    ref = TM.two_matmul_bwd_ref(x, lnw, lnb, w1, b1, w2, None, g,
                                act="gelu", residual=res)[0]
    assert (dx - ref).abs().max() <= 1e-12 * ref.abs().max()


def _rna_tf32(a):
    """cvt.rna.tf32.f32 in numpy (as tests/test_torch_fp32_plans.py)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a - hi)


def _tn_gemm_f32(a, b, splits, tps, passes=3):
    """tn_gemm_tf32_kernel's sums in numpy fp32: each 32-token slice's
    split-TF32 products (lo hi + hi lo, then hi hi; passes 1: hi hi only)
    summed, added to its split's fp32 total in slice order, the splits'
    totals added in split order (colsum)."""
    T, M = a.shape
    N = b.shape[1]
    f = np.float32
    (ah, al), (bh, bl) = _split(a), _split(b)
    out = np.zeros((M, N), f)
    for s in range(splits):
        total = np.zeros((M, N), f)
        for t0 in range(s * tps, min(T, (s + 1) * tps), 32):
            sl = slice(t0, min(T, t0 + 32), None)
            tile = ah[sl].T @ bh[sl]
            if passes == 3:
                tile = ((al[sl].T @ bh[sl] + ah[sl].T @ bl[sl]).astype(f)
                        + tile).astype(f)
            total = (total + tile.astype(f)).astype(f)
        out = (out + total).astype(f)
    return out


@pytest.mark.parametrize("T,M,N", [(131072, 64, 64), (131072, 16, 64),
                                   (32768, 64, 64), (1000, 64, 64)])
def test_long_token_contraction_holds_fp32_accuracy(T, M, N):
    """A^T B over up to 131,072 tokens (dW1 of stage 0 and of the head at
    batch 8) as tn_gemm_tf32_kernel sums it under tn_gemm_plan: 32-token
    slices, each folded into its split's fp32 total, the splits added in
    order.  Against float64 it holds 2^-21-class accuracy of max|ref|
    (within 4 x 2^-21, as plain fp32 sums do); one TF32 pass misses that
    by far."""
    splits, tps = tn_gemm_plan(T, M, N, torch.float32)
    rng = np.random.default_rng(T + M)
    a = rng.normal(0, 1, (T, M)).astype(np.float32)      # dh or g
    b = (rng.normal(0, 1, (T, N)) + 0.5).astype(np.float32)   # y or a
    ref = a.astype(np.float64).T @ b.astype(np.float64)
    scale = np.abs(ref).max()
    got = _tn_gemm_f32(a, b, splits, tps)
    assert np.abs(got - ref).max() <= 4 * 2.0 ** -21 * scale
    one = _tn_gemm_f32(a, b, splits, tps, passes=1)
    assert np.abs(one - ref).max() > 30 * 2.0 ** -21 * scale
