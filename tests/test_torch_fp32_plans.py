"""The launch plans and the arithmetic of the fp32 split-TF32 kernels
(csrc/window_msa.cu window_msa_tf32_kernel for K1 / K2 / K12 / K13,
csrc/mlp.cu two_matmul_tf32_kernel for K3, ln_linear_tf32_kernel for K4),
in plain Python and numpy: no card is needed.

- The plans (ops/window_msa.py:window_msa_plan_f32, ops/mlp.py:
  two_matmul_plan_f32, ln_linear_plan_f32) fit a block's 227 KB of shared
  memory and cover every token row, head, hidden unit, output column and
  32-deep tile of K once, at every shape of TULIP-base and TULIP-large at
  32 x 2048 (batch 1, 2, 8, one process and a W shard of --sp_degree 2 /
  4) and of the SwinV2-T classifier (batch 1, 128).
- Their split launches' partial sums, added in split order, equal the
  unsplit product in float64 (summation order only).
- Split TF32: with hi = rna_tf32(a), lo = rna_tf32(a - hi), the three
  products hi hi + hi lo + lo hi hold fp32's accuracy (within 1e-6 of
  max|float64|), where one TF32 product does not: the reason the kernels
  split.  K4 as its kernel computes it (the rows' statistics in the
  statistics pass's order, LN applied as each tile splits, the tiles
  folded, the splits added in order) holds it too."""

import numpy as np
import pytest
import torch

from tulip_tpu_torch.ops import mlp as TM
from tulip_tpu_torch.ops import window_msa as TW

SMEM_MAX = 232448          # shared bytes a block can use on sm_90
SM_SMEM = 233472           # shared bytes of an SM; 1 KB kept per block

# (tokens of one image, C, heads) of each Swin stage at 32 x 2048
BASE = [(32 * 512, 96, 3), (16 * 256, 192, 6), (8 * 128, 384, 12),
        (4 * 64, 768, 24)]
LARGE = BASE + [(2 * 32, 1536, 48)]
HEAD = (32 * 512, 96, 1536)            # the folded head: tokens, C, Hd
# SwinV2-T at 224 x 224: tokens of one image and C of its four stages
CLASSIFIER = [(3136, 96), (784, 192), (196, 384), (49, 768)]


def _msa_shapes():
    """(T, C, nh) of every K1 / K2 launch of TULIP-base and -large at batch
    1, 2, 8, in one process and on one W shard of --sp_degree 2 and 4."""
    return sorted({(t * b // sp, c, nh) for stages in (BASE, LARGE)
                   for t, c, nh in stages for b in (1, 2, 8)
                   for sp in (1, 2, 4)})


def _mlp_shapes():
    """(N, C, Hd, O, what) of every K3 launch: TULIP-base and -large MLPs
    and the folded head (one to three channels) at batch 1, 2, 8 and W
    shards of --sp_degree 2 / 4; the classifier's MLPs at batch 1 and 128."""
    out = set()
    for stages in (BASE, LARGE):
        for b in (1, 2, 8):
            for sp in (1, 2, 4):
                for t, c, _ in stages:
                    out.add((t * b // sp, c, 4 * c, c, "mlp"))
                t, c, hd = HEAD
                for chans in (1, 2, 3):
                    out.add((t * b // sp, c, hd, 16 * chans, "head"))
    for b in (1, 128):
        for t, c in CLASSIFIER:
            out.add((t * b, c, 4 * c, c, "classifier"))
    return sorted(out)


@pytest.mark.parametrize("T,C,nh", _msa_shapes())
def test_msa_f32_plan_fits_and_covers(T, C, nh):
    p = TW.window_msa_plan_f32(T, C, nh)
    assert p["rows"] == 64 and p["stages"] == 3
    # 1 KB alignment room, 3 stages of (96 + 64) rows x 128 bytes as hi and
    # lo, four warps' 16 x 36 floats of v, 64 rows' statistics and offsets
    fixed = 1024 + 3 * 2 * 160 * 128 + 4 * 16 * 36 * 4 + 64 * 8 + 64 * 8
    assert TW.F32_FIXED == fixed and TW.F32_HEAD == 2 * 64 * 32 * 4
    assert p["smem"] == fixed + p["hs"] * TW.F32_HEAD <= SMEM_MAX
    # every head in exactly one split, none empty
    heads = [h for s in range(p["splits"])
             for h in range(s * p["hs"], min((s + 1) * p["hs"], nh))]
    assert heads == list(range(nh)) and p["hs"] * (p["splits"] - 1) < nh
    assert p["sum_launch"] == (p["splits"] > 1)
    # every token row in exactly one 64-row tile
    tiles = -(-T // 64)
    rows = [r for t in range(tiles)
            for r in range(64 * t, min(64 * t + 64, T))]
    assert rows == list(range(T))
    # split no further than shared memory forces where the row tiles fill
    # the card; the optional splits' partial sums stay under the cap
    forced = -(-nh // min(nh, (SMEM_MAX - fixed) // TW.F32_HEAD))
    assert p["splits"] >= forced
    if tiles >= 132:
        assert p["splits"] == forced
    if p["splits"] > forced:
        assert p["splits"] * T * C * 4 <= TW.PARTIAL_CAP


@pytest.mark.parametrize("N,C,Hd,O,what", _mlp_shapes())
def test_two_matmul_f32_plan_fits_and_covers(N, C, Hd, O, what):
    p = TM.two_matmul_plan_f32(N, C, Hd, O)
    assert p["rows"] == 64 and p["stages"] == 3
    # 1 KB alignment room, 3 stages of 128 rows x 128 bytes as hi and lo,
    # 64 rows' LN statistics; two blocks share an SM
    assert p["smem"] == TM.SMEM_F32 == 1024 + 3 * 2 * 128 * 128 + 64 * 8
    assert TM.SMEM_F32 <= TM.SMEM_TWO_PER_SM
    assert 2 * (p["smem"] + 1024) <= SM_SMEM and p["smem"] <= SMEM_MAX
    # output columns: chunks of bo, each column in exactly one chunk; the
    # folded head (O = 16 c) and the widths up to 96 fused in one chunk,
    # 192 in two; wider outputs in two passes over 64-column tiles
    assert p["two_pass"] == (O > 192 or (O > 96 and O % 96 != 0))
    assert p["bo"] in ((64,) if p["two_pass"] else (16, 32, 96))
    assert p["chunks"] == -(-O // p["bo"])
    assert (p["chunks"] - 1) * p["bo"] < O
    if not p["two_pass"]:
        assert p["chunks"] <= 2
    # hidden units: splits of hs, each unit in exactly one split and one
    # tile of it (64 units fused, a 32-deep K tile two-pass), none empty
    unit = 32 if p["two_pass"] else 64
    hs, splits = p["hs"], p["splits"]
    assert hs % unit == 0 and splits == -(-Hd // hs)
    units = []
    for s in range(splits):
        hn = min(hs, Hd - s * hs)
        assert hn > 0
        for t in range(-(-hn // unit)):
            units += range(s * hs + unit * t,
                           s * hs + min(unit * t + unit, hn))
    assert units == list(range(Hd))
    # the token count sets the row tiles and nothing else: every token's
    # sums run in one order at any N (a W shard, a data rank, one process)
    for n in (1, 63, N // 2 + 1, 8 * N):
        assert TM.two_matmul_plan_f32(n, C, Hd, O) == p


@pytest.mark.parametrize("N,C,Hd,O", [
    (16384, 96, 384, 96), (4096, 192, 768, 192), (1024, 384, 1536, 384),
    (256, 768, 3072, 768), (16384, 96, 1536, 16)])
def test_two_matmul_f32_plan_fills_the_card_at_batch_1(N, C, Hd, O):
    """TULIP-base's batch-1 K3 launches (the default evaluation) give at
    least one CTA per SM in each launch: the fused kernel's row tiles x
    chunks x splits, the two-pass form's first pass (row tiles x 64-unit
    column tiles) and second (row tiles x 64-column tiles x splits)."""
    p = TM.two_matmul_plan_f32(N, C, Hd, O)
    rt = -(-N // 64)
    if p["two_pass"]:
        assert rt * -(-Hd // 64) >= TM.NUM_SMS
    assert rt * p["chunks"] * p["splits"] >= TM.NUM_SMS


def test_f32_plans_split_where_rows_are_few():
    """Stage 3 at batch 1 (256 tokens, 4 row tiles): the half-block splits
    its 24 heads towards the SMs; with 2,048 row tiles it keeps the four
    splits that six heads' ao tiles a block force at C 768.  K3 splits by
    its widths alone: five splits of the second pass at C 768, none at
    stage 0 or for the head."""
    m1, m8 = (TW.window_msa_plan_f32(T, 768, 24) for T in (256, 131072))
    assert m1["splits"] > 4 and m1["splits"] * 4 <= 132
    assert m8["splits"] == 4 and m8["hs"] == 6
    assert TW.window_msa_plan_f32(131072, 96, 3)["splits"] == 1
    k1 = TM.two_matmul_plan_f32(256, 768, 3072, 768)
    assert k1["splits"] == 5 and k1["two_pass"] and k1["chunks"] == 12
    assert TM.two_matmul_plan_f32(131072, 96, 384, 96)["splits"] == 1
    assert TM.two_matmul_plan_f32(131072, 96, 1536, 16)["splits"] == 1


@pytest.mark.parametrize("N,C,Hd,O,ln,res", [
    (256, 768, 3072, 768, True, True),     # stage 3, batch 1: two-pass
    (1024, 384, 1536, 384, True, True),    # stage 2, batch 1: two-pass
    (49, 768, 3072, 768, False, False),    # the classifier's last stage
    (64, 1536, 6144, 1536, True, True),    # TULIP-large's last stage
    (300, 192, 768, 192, True, True),      # stage 1: fused, 2 chunks
])
def test_f32_split_hidden_partial_sums_equal_plain_float64(N, C, Hd, O, ln,
                                                           res):
    """What the fp32 K3's split launches compute: each split's hidden
    units (64 at a time fused, a 32-deep K tile at a time in the second
    pass of the two-pass form) give a partial out for each chunk of bo
    output columns; the partials added in split order (then + b2 + x)
    equal the plain version to float64 summation order (1e-12 of
    max|ref|)."""
    p = TM.two_matmul_plan_f32(N, C, Hd, O)
    assert p["splits"] > 1
    unit = 32 if p["two_pass"] else 64
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s))
    x = t(N, C)
    lnw, lnb = (t(C), t(C)) if ln else (None, None)
    w1, b1, w2, b2 = t(Hd, C) * C ** -0.5, t(Hd), t(O, Hd) * Hd ** -0.5, t(O)
    y = x if lnw is None else TM.layer_norm(x, lnw, lnb, 1e-6)
    a = TM.gelu(y @ w1.T + b1)
    out = torch.zeros(N, O, dtype=torch.float64)
    for s in range(p["splits"]):                       # split order
        part = torch.zeros(N, O, dtype=torch.float64)
        for c in range(p["chunks"]):
            cols = slice(c * p["bo"], min(O, (c + 1) * p["bo"]))
            for u in range(s * p["hs"], min(Hd, (s + 1) * p["hs"]), unit):
                units = slice(u, min(Hd, u + unit))
                part[:, cols] += a[:, units] @ w2[cols, units].T
        out += part
    out = out + b2 + (x if res else 0)
    ref = TM.fused_two_matmul_ref(x, lnw, lnb, w1, b1, w2, b2, act="gelu",
                                  residual=res)
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()


@pytest.mark.parametrize("T,C,nh", [(256, 768, 24), (1024, 384, 12),
                                    (4096, 192, 6), (64, 1536, 48)])
def test_f32_split_order_sum_is_the_unsplit_proj(T, C, nh):
    """What window_msa_sum_f32_kernel adds: proj over the plan's head
    splits, each split's heads in order, the splits in split order, then
    + bias + x, against the unsplit proj + bias + x in float64 (summation
    order only: 1e-12 of max|ref|)."""
    p = TW.window_msa_plan_f32(T, C, nh)
    assert p["splits"] > 1
    rng = np.random.default_rng(13)
    n = min(T, 128)
    o = torch.from_numpy(rng.normal(0, 1, (n, C)))      # the head outputs
    wproj = torch.from_numpy(rng.normal(0, C ** -0.5, (C, C)))
    bproj = torch.from_numpy(rng.normal(0, 0.1, (C,)))
    x = torch.from_numpy(rng.normal(0, 1, (n, C)))
    total = torch.zeros(n, C, dtype=torch.float64)
    for s in range(p["splits"]):
        part = torch.zeros(n, C, dtype=torch.float64)
        for h in range(s * p["hs"], min(nh, (s + 1) * p["hs"])):
            cols = slice(32 * h, 32 * h + 32)
            part += o[:, cols] @ wproj[:, cols].T
        total += part
    out = total + bproj + x
    ref = o @ wproj.T + bproj + x
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()


def _rna_tf32(a):
    """cvt.rna.tf32.f32 in numpy: round an fp32 array to TF32's 10-bit
    mantissa, to nearest, ties away from zero (add half of the dropped 13
    bits to the magnitude, then drop them); the result is an fp32 array."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(a):
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a - hi)


def test_rna_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12,
                  -(1.0 + 2 ** -11), 3.14159265, 0.0], np.float32)
    got = _rna_tf32(x)
    want = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                     -(1.0 + 2 ** -10), 3.140625, 0.0], np.float32)
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi + lo keeps 21 bits of the 24: |a - hi - lo| <= 2^-22 |a|
    rng = np.random.default_rng(14)
    a = rng.normal(0, 1, 100000).astype(np.float32)
    hi, lo = _split(a)
    rest = np.abs(a.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -22 * np.abs(a)).all()


@pytest.mark.parametrize("K", [96, 192, 384, 768, 1536, 3072])
def test_split_tf32_products_hold_fp32_accuracy(K):
    """A (64 x K) B (K x 96) as the kernels compute it: the TF32 products
    of the split operands (exact in fp32) summed in fp32, lo hi + hi lo
    first, then hi hi; against float64 within 1e-6 of max|ref|, as fp32
    itself is.  One TF32 product (hi hi) misses that by two orders; per
    product the split leaves under 2^-21 of |a b|."""
    rng = np.random.default_rng(K)
    a = rng.normal(0, 1, (64, K)).astype(np.float32)        # LN outputs
    b = (rng.normal(0, 1, (K, 96)) * K ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    (ah, al), (bh, bl) = _split(a), _split(b)
    three = (al @ bh + ah @ bl) + ah @ bh
    one = ah @ bh
    assert np.abs(three - ref).max() <= 1e-6 * scale
    assert np.abs((a @ b) - ref).max() <= 1e-6 * scale      # fp32 itself
    assert np.abs(one - ref).max() > 1e-4 * scale
    # one product at a time, in float64: the dropped lo lo term and lo's
    # rounding
    x, y = a[0].astype(np.float64), b[:, 0].astype(np.float64)
    xh, xl = (v.astype(np.float64) for v in _split(a[0]))
    yh, yl = (v.astype(np.float64) for v in _split(b[:, 0]))
    prod = xh * yh + xh * yl + xl * yh
    assert (np.abs(prod - x * y) <= 2.0 ** -21 * np.abs(x * y)).all()
    assert (np.abs(xh * yh - x * y) > 2.0 ** -16 * np.abs(x * y)).any()


# ---------------------------------------------------------------------------
# fp32 K4: ops/mlp.py:ln_linear_plan_f32 and ln_linear_tf32_kernel's sums
# ---------------------------------------------------------------------------

def _merge_f32_shapes():
    """(N, K) of every fp32 K4 launch: the merges of TULIP-base and -large
    (a stage's tokens / 4 at 4 C) at batch 1, 2, 8, in one process and on
    a W shard of --sp_degree 2 / 4, and a ragged token count."""
    out = {(1000, 384)}
    for stages in (BASE, LARGE):
        for b in (1, 2, 8):
            for sp in (1, 2, 4):
                for t, c, _ in stages[:-1]:
                    out.add((t * b // 4 // sp, 4 * c))
    return sorted(out)


@pytest.mark.parametrize("N,K", _merge_f32_shapes())
def test_ln_linear_f32_plan_fits_and_covers(N, K):
    O = K // 2
    p = TM.ln_linear_plan_f32(N, K, O)
    assert p["rows"] == 64 and p["bn"] == 64 and p["stages"] == 3
    # the K3 kernels' ring: two blocks share an SM
    assert p["smem"] == TM.SMEM_F32 <= TM.SMEM_TWO_PER_SM
    # every 32-deep tile of K in exactly one split, none empty
    kt, kts, splits = K // 32, p["kts"], p["splits"]
    assert kts * 32 <= TM.F32_LN_DEPTH and splits == -(-kt // kts)
    tiles = []
    for s in range(splits):
        mine = range(s * kts, min((s + 1) * kts, kt))
        assert len(mine) > 0
        tiles += mine
    assert tiles == list(range(kt))
    # the split launches' partial sums stay under the cap: rows in launches
    # of max_rows (64-row tiles, so each launch's tiles are the unsplit
    # call's), every row in exactly one
    if splits == 1:
        assert p["max_rows"] is None
    else:
        m = p["max_rows"]
        assert m % 64 == 0 and splits * m * O * 4 <= TM.PARTIAL_CAP
        rows = [r for r0 in range(0, N, m) for r in range(r0, min(N, r0 + m))]
        assert rows == list(range(N))


@pytest.mark.parametrize("K", [384, 768, 1536, 3072])
def test_ln_linear_f32_plan_ignores_the_token_count(K):
    """The token count sets the row tiles and nothing else: a token's sums
    run in one order in a batch-1 call, a W shard, a data rank or a batch
    of eight."""
    plans = [TM.ln_linear_plan_f32(n, K, K // 2)
             for n in (1, 64, 1000, 4096, 32768)]
    assert all(q == plans[0] for q in plans)
    assert plans[0]["splits"] == K // 384


@pytest.mark.parametrize("N,K", [(4096, 384), (1024, 768), (256, 1536),
                                 (64, 3072)])
def test_ln_linear_f32_plan_fills_the_card_at_batch_1(N, K):
    """TULIP-base's batch-1 merges (the default evaluation) and
    TULIP-large's deepest give at least one CTA per SM: row tiles x
    64-column tiles x splits = 192 each."""
    p = TM.ln_linear_plan_f32(N, K, K // 2)
    ctas = -(-N // 64) * -(-(K // 2) // 64) * p["splits"]
    assert ctas == 192 >= TM.NUM_SMS


def _warp_sum(v):
    """warp_sum of csrc/common.cuh on (rows, 32) fp32 lane values: the xor
    butterfly over offsets 16, 8, 4, 2, 1 (every lane ends with the same
    sum)."""
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, np.arange(32) ^ o]).astype(np.float32)
    return v[:, 0]


def _row_mean_rstd(x, eps):
    """csrc/mma.cuh row_mean_rstd on fp32 rows: lane l adds the row's
    16-byte chunks l, l + 32, ..., each as (a + b) + (c + d), the warp adds
    the lanes; then the squared deviations alike."""
    N, K = x.shape
    f = np.float32
    chunks = K // 4
    per = -(-chunks // 32)

    def lanes(parts):   # parts: (N, chunks) -> (N, 32) lane sums in order
        pad = np.zeros((N, per * 32), f)
        pad[:, :chunks] = parts
        acc = np.zeros((N, 32), f)
        for j in range(per):
            acc = (acc + pad[:, 32 * j:32 * j + 32]).astype(f)
        return acc

    c = x.reshape(N, chunks, 4)
    s = ((c[..., 0] + c[..., 1]) + (c[..., 2] + c[..., 3])).astype(f)
    mean = (_warp_sum(lanes(s)) / f(K)).astype(f)
    e = (c - mean[:, None, None]).astype(f)
    e = (e * e).astype(f)
    d = ((e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])).astype(f)
    var = (_warp_sum(lanes(d)) / f(K)).astype(f)
    return mean, (f(1) / np.sqrt(var + f(eps))).astype(f)


@pytest.mark.parametrize("N,K", [(256, 1536), (1024, 768), (100, 384),
                                 (64, 3072)])
def test_ln_linear_f32_split_sums_hold_fp32_accuracy(N, K):
    """What the fp32 K4 computes, modelled in numpy fp32: the rows'
    statistics in the statistics pass's order, the LayerNorm applied to
    each 32-deep tile of x as it splits, each tile's three TF32 products
    summed (lo hi + hi lo, then hi hi) and added to the split's fp32 total
    in tile order, the splits' totals added in split order; against the
    plain LN + product in float64 within 1e-6 of max|ref|, as fp32 itself
    is."""
    O, eps, f = K // 2, 1e-6, np.float32
    rng = np.random.default_rng(K + N)
    x = (rng.normal(0, 1, (N, K)) + rng.normal(0, 2, (N, 1))).astype(f)
    lnw = rng.normal(1, 0.1, K).astype(f)
    lnb = rng.normal(0, 0.1, K).astype(f)
    w = (rng.normal(0, 1, (O, K)) * K ** -0.5).astype(f)
    p = TM.ln_linear_plan_f32(N, K, O)
    mean, rstd = _row_mean_rstd(x, eps)
    out = np.zeros((N, O), f)
    for s in range(p["splits"]):
        total = np.zeros((N, O), f)
        for t in range(s * p["kts"], min((s + 1) * p["kts"], K // 32)):
            cols = slice(32 * t, 32 * t + 32)
            y = ((x[:, cols] - mean[:, None]) * rstd[:, None] * lnw[cols]
                 + lnb[cols]).astype(f)
            (yh, yl), (bh, bl) = _split(y), _split(w[:, cols])
            tile = ((yl @ bh.T + yh @ bl.T) + yh @ bh.T).astype(f)
            total = (total + tile).astype(f)
        out = (out + total).astype(f)
    ref = TM.fused_ln_linear_ref(*(torch.from_numpy(a).double()
                                   for a in (x, lnw, lnb, w)), eps=eps)
    ref = ref.numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-6 * scale
    # the statistics themselves: fp32's accuracy against float64
    x64 = x.astype(np.float64)
    m64 = x64.mean(1)
    r64 = 1 / np.sqrt(((x64 - m64[:, None]) ** 2).mean(1) + eps)
    assert np.abs(mean - m64).max() <= 1e-6 * np.abs(x64).max()
    assert (np.abs(rstd - r64) <= 1e-6 * r64).all()
