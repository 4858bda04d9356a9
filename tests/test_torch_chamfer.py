"""The port's nearest-neighbour sweeps (tulip_tpu_torch.ops.chamfer) against
the JAX package's K7 / K6 / K5 (Pallas, interpret mode on the CPU) and a
numpy brute force, the plan's tables against JAX's, and the rounds of tile
pairs of K5 (both directions) and K6 (one) replayed in torch (bit for bit
against the plain minima: the same direct-form distances and an exact
minimum).

Tolerances: against numpy (the same direct-form fp32 distances) 1e-6
relative + 1e-6 m^2 (summation order of three terms); against JAX rtol 1e-4
and atol 2e-3 to 4e-3 m^2, the expansion-form error of the JAX kernels at
these coordinates (tests/test_chamfer_impls.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tulip_tpu.eval import metrics as JM
from tulip_tpu.ops.pallas import chamfer_h as JH
from tulip_tpu.ops.pallas.chamfer import min_sq_dists_pallas
from tulip_tpu_torch.eval import metrics as TMET
from tulip_tpu_torch.ops import chamfer as C


def _brute(a, b):
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return d.min(1), d.min(0)


def _clustered(rng, n):
    """Separated clusters + a thin ground sheet, shuffled, like a scan."""
    k = n // 4
    clusters = [rng.standard_normal((k, 3)) * 2 + c
                for c in ([30, 0, 0], [-25, 40, 5], [0, -35, -3])]
    sheet = np.stack([rng.uniform(-60, 60, n - 3 * k),
                      rng.uniform(-60, 60, n - 3 * k),
                      rng.uniform(-0.2, 0.2, n - 3 * k)], axis=1)
    pts = np.concatenate(clusters + [sheet]).astype(np.float32)
    rng.shuffle(pts)
    return pts


def _cases():
    rng = np.random.default_rng(0)
    pts = _clustered(rng, 2800)
    sentinel_b = np.concatenate([pts[1400:], np.full((3072 - 1400, 3), 1e8,
                                                     np.float32)])
    uni_a = rng.uniform(-50, 50, (1100, 3)).astype(np.float32)
    uni_b = rng.uniform(-50, 50, (1024, 3)).astype(np.float32)
    same = np.full((700, 3), 7.0, np.float32)
    scan = _clustered(rng, 2048)
    return {
        # ragged N (1400) against a sentinel-padded b, as the callers pad
        "clustered-sentinel-ragged": (pts[:1400], sentinel_b, 1400),
        "uniform": (uni_a, uni_b, 1024),
        "degenerate": (same, same[:512], 512),
        "scan-and-perturbed-copy": (
            scan, (scan + rng.normal(0, 0.05, scan.shape)).astype(np.float32),
            2048),
    }


CASES = _cases()


def _sentinel_grid():
    """Sentinels in a (ragged N) and in b around a grid near the joint box's
    last Morton corner: the tiles that mix real points with sentinels have
    edges that fp32 rounds by metres at 5e7 m (without h2_boxes' infinite
    extent K5's rounds miss 32 minima in each direction here)."""
    rng = np.random.default_rng(3)
    g = (10 + 0.2 * np.arange(15)).astype(np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    a = np.concatenate([pts + rng.normal(0, 0.002, pts.shape)
                        .astype(np.float32),
                        np.full((141, 3), 1e8, np.float32)])
    b = np.concatenate([pts, np.full((17, 3), 1e8, np.float32)])
    return a, b, pts.shape[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_numpy_and_jax_brute(name):
    a, b, m_real = CASES[name]
    ours = C.min_sq_dists_brute(torch.from_numpy(a), torch.from_numpy(b),
                                chunk=512).numpy()
    ref, _ = _brute(a, b[:m_real])
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    jx = np.asarray(min_sq_dists_pallas(jnp.asarray(a), jnp.asarray(b),
                                        chunk=512))
    np.testing.assert_allclose(ours, jx, rtol=1e-4, atol=4e-3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_h_and_h2_match_jax(name):
    a, b, m_real = CASES[name]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref_a, ref_b = _brute(a, b[:m_real])
    d6 = C.min_sq_dists_h(ta, tb, chunk=512).numpy()
    d5a, d5b = (t.numpy() for t in C.min_sq_dists_h2(ta, tb, chunk=512))
    np.testing.assert_allclose(d6, ref_a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d5a, ref_a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d5b[:m_real], ref_b, rtol=1e-6, atol=1e-6)
    j6 = np.asarray(JH.min_sq_dists_pallas_h(jnp.asarray(a), jnp.asarray(b),
                                             chunk=512))
    j5a, j5b = (np.asarray(t) for t in JH.min_sq_dists_pallas_h2(
        jnp.asarray(a), jnp.asarray(b), chunk=512))
    np.testing.assert_allclose(d6, j6, rtol=1e-4, atol=4e-3)
    np.testing.assert_allclose(d5a, j5a, rtol=1e-4, atol=4e-3)
    # JAX pads a ragged a with sentinels that enter its column minima, so
    # only the real b rows are compared
    np.testing.assert_allclose(d5b[:m_real], j5b[:m_real], rtol=1e-4,
                               atol=4e-3)


def test_tables_match_jax():
    """Morton codes, orders, AABBs and bounds of the K5 plan equal the JAX
    wrapper's at a tile multiple (JAX's tile is 1024)."""
    a, b, _ = CASES["scan-and-perturbed-copy"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pa, pb = C._morton_order(ta, tb)
    lo = torch.minimum(ta.amin(0), tb.amin(0))
    span = torch.clamp(torch.maximum(ta.amax(0), tb.amax(0)) - lo, min=1e-6)
    codes = C._morton10(ta, lo, span).numpy()
    jcodes = np.asarray(JH._morton10(jnp.asarray(a), jnp.asarray(lo.numpy()),
                                     jnp.asarray(span.numpy())))
    np.testing.assert_array_equal(codes, jcodes.astype(np.int64))
    np.testing.assert_array_equal(
        pa.numpy(), np.argsort(jcodes, kind="stable"))
    for pts, perm, tile in ((a, pa, 1024), (b, pb, 512)):
        sorted_pts = pts[perm.numpy()]
        c, h = C._tile_boxes(torch.from_numpy(sorted_pts), tile)
        jc, jh = JH._tile_boxes(jnp.asarray(sorted_pts), tile)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    _, _, a_s, b_s, lb_sorted, order = C.plan(ta, tb, 512, tile=1024)
    ca, ha = JH._tile_boxes(jnp.asarray(a_s.numpy()), 1024)
    cb, hb = JH._tile_boxes(jnp.asarray(b_s.numpy()), 512)
    gap = jnp.maximum(jnp.abs(ca[:, None, :] - cb[None, :, :])
                      - ha[:, None, :] - hb[None, :, :], 0.0)
    lb_lin = jnp.maximum(jnp.sqrt(jnp.sum(gap * gap, axis=-1)) - 1e-3, 0.0)
    jlb = np.asarray(lb_lin * lb_lin)
    jorder = np.argsort(jlb, axis=1, kind="stable")
    np.testing.assert_allclose(lb_sorted.numpy(),
                               np.take_along_axis(jlb, jorder, 1), rtol=1e-6)
    np.testing.assert_array_equal(order.numpy(), jorder)


def _unsort(d_sorted, perm):
    """Scatter sorted-order values back to the caller's point order."""
    out = torch.empty_like(d_sorted)
    out[perm] = d_sorted
    return out


def _sweep_pairs(sel, a_s, b_s, da, db):
    """The plain minima of every listed tile pair, folded into da and, in
    both directions (db not None), db."""
    N, R, K = a_s.shape[0], C.H2_ROWS, C.H2_COLS
    for i, j in sel.nonzero().tolist():
        rows = slice(i * R, min((i + 1) * R, N))
        cols = slice(j * K, (j + 1) * K)
        da[rows] = torch.minimum(da[rows],
                                 C._min_sq_dists(a_s[rows], b_s[cols], K))
        if db is not None:
            db[cols] = torch.minimum(db[cols],
                                     C._min_sq_dists(b_s[cols], a_s[rows], R))


def _replay_h2(a, b, both=True):
    """The rounds of K5 (``both``) or K6 on the CPU: the first pairs, then
    for each fraction the upper bounds from the minima so far and the pairs
    they list.  Returns (d_a, d_b (None for K6), pairs per round, the union
    of the rounds, the bound table, the Morton orders)."""
    pa, pb, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(a, b)
    lb = C.box_lb_table(ca, ha, cb, hb)
    da = torch.full((a.shape[0],), 1e30)
    db = torch.full((b.shape[0],), 1e30) if both else None
    done = C.h2_first_pairs(lb, both)
    counts = [int(done.sum())]
    _sweep_pairs(done, a_s, b_s, da, db)
    for frac in C.H2_FRACS:
        sel = C.h2_round_pairs(lb, *C.h2_upper_bounds(da, db), frac, done)
        _sweep_pairs(sel, a_s, b_s, da, db)
        done |= sel
        counts.append(int(sel.sum()))
    return (_unsort(da, pa), None if db is None else _unsort(db, pb),
            counts, done, lb, (pa, pb))


def _skip_cloud():
    rng = np.random.default_rng(5)
    a = _clustered(rng, 3000)
    b = np.concatenate([(a[:2800] + rng.normal(0, 0.05, (2800, 3)))
                        .astype(np.float32),
                        np.full((272, 3), 1e8, np.float32)])
    return a, b, 2800


@pytest.mark.parametrize("pair", [False, True])
def test_skip_rule_is_exact(pair):
    """The rounds of first pairs and upper bounds (ragged N = 3000 against a
    b padded with sentinels) give the plain minima exactly and leave pairs
    out: K6 (pair False) in one direction, K5 (pair True) in both."""
    a, b, m_real = _skip_cloud()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref_a, ref_b = _brute(a, b[:m_real])
    if not pair:
        d_a, _, counts, done, _, _ = _replay_h2(ta, tb, both=False)
        assert torch.equal(d_a, C.min_sq_dists_plain(ta, tb, 32))
        np.testing.assert_allclose(d_a.numpy(), ref_a, rtol=1e-6, atol=1e-6)
        assert sum(counts) == int(done.sum()) < done.numel()
        return
    d_a, d_b, counts, done, _, _ = _replay_h2(ta, tb)
    assert torch.equal(d_a, C.min_sq_dists_plain(ta, tb, 32))
    assert torch.equal(d_b[:m_real], C._min_sq_dists(tb, ta, 1000)[:m_real])
    np.testing.assert_allclose(d_b.numpy()[:m_real], ref_b, rtol=1e-6,
                               atol=1e-6)
    assert sum(counts) == int(done.sum()) < done.numel()


@pytest.mark.parametrize("name", sorted(CASES))
def test_h2_rounds_are_exact_and_cover_the_needed_pairs(name):
    """On every cloud: the rounds give the plain minima bit for bit in both
    directions (real rows of b), no pair is listed twice, and every tile
    pair that the true minima need (its bound at or below the worst true
    minimum of its query tile or of its target tile) is listed."""
    a, b, m_real = CASES[name]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d_a, d_b, counts, done, lb, (pa, pb) = _replay_h2(ta, tb)
    ref_a = C.min_sq_dists_plain(ta, tb, 32)
    ref_b = C._min_sq_dists(tb, ta, 100)
    assert torch.equal(d_a, ref_a)
    assert torch.equal(d_b[:m_real], ref_b[:m_real])
    assert sum(counts) == int(done.sum())
    ub_a, ub_b = C.h2_upper_bounds(ref_a[pa], ref_b[pb])
    need = (lb <= ub_a[:, None]) | (lb <= ub_b[None, :])
    assert not (need & ~done).any()


def test_h2_lists_less_than_all_pairs_on_a_scan():
    """On a scan against a perturbed copy the rounds list a small share of
    the tile pairs, near the share the true minima need."""
    a, b, _ = CASES["scan-and-perturbed-copy"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d_a, d_b, counts, done, lb, (pa, pb) = _replay_h2(ta, tb)
    ub_a, ub_b = C.h2_upper_bounds(d_a[pa], d_b[pb])
    need = (lb <= ub_a[:, None]) | (lb <= ub_b[None, :])
    assert int(need.sum()) <= int(done.sum()) < done.numel() // 2


ONE_WAY_CASES = dict(CASES, **{"skip-cloud": _skip_cloud(),
                                "sentinels-both-ragged": _sentinel_grid()})


@pytest.mark.parametrize("name", sorted(ONE_WAY_CASES))
def test_h1_rounds_are_exact_and_cover_the_needed_pairs(name):
    """K6's rounds on every cloud (and on sentinels in a and in b with a
    ragged N): the plain minima bit for bit, no pair listed twice, every
    tile pair that the true minima need (its bound at or below the worst
    true minimum of its query tile) listed, and no more pairs than K5's
    rounds list for both directions."""
    a, b, _ = ONE_WAY_CASES[name]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    d_a, d_b, counts, done, lb, (pa, _) = _replay_h2(ta, tb, both=False)
    ref_a = C.min_sq_dists_plain(ta, tb, 32)
    assert d_b is None and torch.equal(d_a, ref_a)
    assert sum(counts) == int(done.sum())
    ub_a, _ = C.h2_upper_bounds(ref_a[pa])
    assert not ((lb <= ub_a[:, None]) & ~done).any()
    assert sum(counts) <= sum(_replay_h2(ta, tb)[2])


def test_mixed_sentinel_tiles_get_a_zero_bound():
    """The tiles that mix real points with sentinels get an infinite
    half-extent, and with it K5's rounds give the plain minima in both
    directions where the plain boxes' rounded edges hid 32 minima a side."""
    a, b, _ = _sentinel_grid()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _, _, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(ta, tb)
    for pts, c, h, tile in ((a_s, ca, ha, C.H2_ROWS),
                            (b_s, cb, hb, C.H2_COLS)):
        real = (pts.abs() < 1e7).all(1)
        real = torch.cat([real, real[-1:].expand((-pts.shape[0]) % tile)])
        n_real = real.reshape(-1, tile).sum(1)
        mixed = (n_real > 0) & (n_real < tile)
        assert int(mixed.sum()) == 1
        assert torch.isinf(h[mixed]).all() and torch.isfinite(h[~mixed]).all()
        assert torch.equal(c, C._tile_boxes(pts, tile)[0])
    d_a, d_b, _, _, _, _ = _replay_h2(ta, tb)
    assert torch.equal(d_a, C.min_sq_dists_plain(ta, tb, 32))
    assert torch.equal(d_b, C._min_sq_dists(tb, ta, 100))


def test_h2_tables_match_jax():
    """K5's tile boxes at its own sizes (128 queries, 32 targets) equal
    JH._tile_boxes, and its bound table the JAX formula of
    min_sq_dists_pallas_h2 on those boxes."""
    a, b, _ = CASES["scan-and-perturbed-copy"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pa, pb, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(ta, tb)
    ref_pa, ref_pb = C._morton_order(ta, tb)
    assert torch.equal(pa, ref_pa) and torch.equal(pb, ref_pb)
    for (c, h), pts, tile in (((ca, ha), a_s, C.H2_ROWS),
                              ((cb, hb), b_s, C.H2_COLS)):
        jc, jh = JH._tile_boxes(jnp.asarray(pts.numpy()), tile)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    lb = C.box_lb_table(ca, ha, cb, hb)
    jca, jha, jcb, jhb = (jnp.asarray(t.numpy()) for t in (ca, ha, cb, hb))
    gap = jnp.maximum(jnp.abs(jca[:, None, :] - jcb[None, :, :])
                      - jha[:, None, :] - jhb[None, :, :], 0.0)
    lb_lin = jnp.maximum(jnp.sqrt(jnp.sum(gap * gap, axis=-1)) - 1e-3, 0.0)
    np.testing.assert_allclose(lb.numpy(), np.asarray(lb_lin * lb_lin),
                               rtol=1e-6)
    assert lb.shape == (C.h2_sizes(*a.shape[:1], b.shape[0])[:2])


def test_h2_sizes():
    assert C.h2_sizes(262144, 262144) == (2048, 8192, 256)
    assert C.h2_sizes(1400, 3072) == (11, 96, 3)
    with pytest.raises(ValueError, match="multiple"):
        C.h2_sizes(100, 1000)
    assert C.h2_sizes(128 * 2 ** 14, 32 * (2 ** 17 - 1)) == (
        2 ** 14, 2 ** 17 - 1, 2 ** 12)
    with pytest.raises(ValueError, match="K5 takes"):
        C.h2_sizes(2 ** 22, 2 ** 21)
    with pytest.raises(ValueError, match="K6 takes"):
        C.h2_sizes(2 ** 22, 2 ** 21, "K6")


def test_h2_s_threshold():
    """lb < t exactly when the squared gap s < h2_s_threshold(t), for s and
    t across the scales of the bounds (0, the slack's square, metres, the
    1e8 sentinels' 3e16) and for t = lb of some of the s themselves."""
    g = torch.Generator().manual_seed(0)
    s = torch.cat([torch.rand(20000, generator=g) ** 4 * 100,
                   torch.tensor([0.0, 1e-6, 1e-6 + 1e-12, 1e6, 3e16])])
    t = torch.cat([torch.rand(200, generator=g) ** 3 * 100,
                   torch.tensor([0.0, -1.0, 1e-12, 1e-7, 5e16,
                                 float("inf")]), C._lb_of(s[:100])])
    thr = C.h2_s_threshold(t)
    assert torch.equal(C._lb_of(s)[None] < t[:, None],
                       s[None] < thr[:, None])


def _warp_s_threshold(t):
    """csrc/chamfer.cu:s_threshold step by step: 32 probes a step, one
    ballot, the step between the last probe below t and the first at or
    above it."""
    if not t > 0:
        return 0.0
    lo, hi = 0, 0x7F800000

    def lb(bits):
        s = torch.tensor([bits], dtype=torch.int32).view(torch.float32)
        return float(C._lb_of(s)[0])

    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        probes = [min(lo + step * (lane + 1), hi) for lane in range(32)]
        ge = [p == hi or lb(p) >= t for p in probes]
        f = ge.index(True)
        assert all(ge[f:])                  # the ballot is a run of ones
        lo, hi = lo + step * f, min(lo + step * (f + 1), hi)
    return float(torch.tensor([hi], dtype=torch.int32).view(torch.float32))


def test_h2_warp_search_finds_the_threshold():
    """The kernel's 32-way search and the plain binary search agree."""
    t = torch.tensor([0.0, 1e-12, 1e-7, 2.5e-3, 0.31, 7.0, 1234.5, 3e16,
                      float("inf")], dtype=torch.float32)
    ref = C.h2_s_threshold(t)
    for k in range(t.numel()):
        assert _warp_s_threshold(float(t[k])) == float(ref[k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_h2_threshold_tests_select_the_rounds_pairs(name):
    """The kernels' form of the rules: round 0 as squared gap < the
    threshold of the float above the row's (column's) smallest bound, a
    later round as squared gap < the threshold of frac x ub; both select
    exactly the pairs of h2_first_pairs / h2_round_pairs."""
    a, b, _ = CASES[name]
    _, _, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(torch.from_numpy(a),
                                                  torch.from_numpy(b))
    s = C.box_gap2_table(ca, ha, cb, hb)
    lb = C._lb_of(s)
    inf = torch.tensor(float("inf"))
    first = ((s < C.h2_s_threshold(torch.nextafter(lb.amin(1), inf))[:, None])
             | (s < C.h2_s_threshold(torch.nextafter(lb.amin(0), inf))[None]))
    assert torch.equal(first, C.h2_first_pairs(lb))
    d_a = C.min_sq_dists_plain(a_s, b_s, 32)
    d_b = C._min_sq_dists(b_s, a_s, 100)
    ub_a, ub_b = C.h2_upper_bounds(d_a * 4, d_b * 4)
    for frac in C.H2_FRACS:
        thr_a = C.h2_s_threshold(frac * ub_a)
        thr_b = C.h2_s_threshold(frac * ub_b)
        later = ((s < thr_a[:, None]) | (s < thr_b[None])) & ~first
        assert torch.equal(later, C.h2_round_pairs(lb, ub_a, ub_b, frac,
                                                   first))
        # the list kernel passes over a word of 32 target tiles when its
        # smallest s reaches both the row's threshold and the word's
        # largest column threshold: no pair of the round lies there
        pad = (-s.shape[1]) % 32
        sw = torch.nn.functional.pad(s, (0, pad), value=float("inf"))
        tw = torch.nn.functional.pad(thr_b, (0, pad))
        smin = sw.reshape(s.shape[0], -1, 32).amin(2)
        wmax = tw.reshape(-1, 32).amax(1)
        keep = (smin < thr_a[:, None]) | (smin < wmax[None])
        assert not (later & ~keep.repeat_interleave(32, 1)[:, :s.shape[1]]
                    ).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_h1_threshold_tests_select_the_rounds_pairs(name):
    """K6's kernels' form of its rules: round 0 as squared gap < the
    threshold of the float above the row's smallest bound, a later round as
    squared gap < the threshold of frac x ub_a alone; they select exactly
    the pairs of h2_first_pairs / h2_round_pairs in one direction, and the
    list kernel's word test (smallest s of 32 target tiles < the row's
    threshold) passes over none of them."""
    a, b, _ = CASES[name]
    _, _, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(torch.from_numpy(a),
                                                  torch.from_numpy(b))
    s = C.box_gap2_table(ca, ha, cb, hb)
    lb = C._lb_of(s)
    inf = torch.tensor(float("inf"))
    first = s < C.h2_s_threshold(torch.nextafter(lb.amin(1), inf))[:, None]
    assert torch.equal(first, C.h2_first_pairs(lb, both=False))
    ub_a, ub_b = C.h2_upper_bounds(C.min_sq_dists_plain(a_s, b_s, 32) * 4)
    assert ub_b is None
    pad = (-s.shape[1]) % 32
    smin = torch.nn.functional.pad(s, (0, pad), value=float("inf")).reshape(
        s.shape[0], -1, 32).amin(2)
    for frac in C.H2_FRACS:
        thr_a = C.h2_s_threshold(frac * ub_a)
        later = (s < thr_a[:, None]) & ~first
        assert torch.equal(later, C.h2_round_pairs(lb, ub_a, None, frac,
                                                   first))
        keep = (smin < thr_a[:, None]).repeat_interleave(32, 1)
        assert not (later & ~keep[:, :s.shape[1]]).any()


def test_h2_one_argsort_orders_both_clouds():
    """The device plan sorts a's codes and b's codes tagged with bit 30 in
    one stable argsort: its two halves are _morton_order's two orders."""
    a, b, _ = CASES["clustered-sentinel-ragged"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    lo_a, hi_a = C._real_box(ta)
    lo_b, hi_b = C._real_box(tb)
    lo = torch.minimum(lo_a, lo_b)
    span = torch.clamp(torch.maximum(hi_a, hi_b) - lo, min=1e-6)
    codes = torch.cat([C._morton10(ta, lo, span),
                       C._morton10(tb, lo, span) | (1 << 30)]).to(torch.int32)
    perm = torch.argsort(codes, stable=True)
    pa, pb = C._morton_order(ta, tb)
    N = a.shape[0]
    assert torch.equal(perm[:N], pa) and torch.equal(perm[N:] - N, pb)


def test_h2_buffers():
    """The scratch of one call, carved from two allocations (on the meta
    device here), and the counts apart: every piece at its size, the list
    at one int per tile pair."""
    N, M = 262144, 262144
    buf = C._h2_buffers(N, M, "meta")
    Ti, Tj, W = C.h2_sizes(N, M)
    sizes = {k: v.numel() for k, v in buf.items()}
    assert sizes == dict(partial=6 * 264, boxes=6 * (Ti + Tj), thr=Ti + Tj,
                         wmax=W, smin=Ti * W, a_s=3 * N, b_s=3 * M, sa=N,
                         sb=M, codes=N + M, counts=8, done=Ti * W,
                         list=Ti * Tj)
    assert buf["list"].dtype == torch.int32
    assert buf["thr"].dtype == torch.float32


def test_h1_buffers():
    """K6's scratch: K5's without the column thresholds, the word maxima
    and the column minima; the list still one int per tile pair."""
    N, M = 262144, 262144
    buf = C._h2_buffers(N, M, "meta", both=False)
    Ti, Tj, W = C.h2_sizes(N, M)
    sizes = {k: v.numel() for k, v in buf.items()}
    assert sizes == dict(partial=6 * 264, boxes=6 * (Ti + Tj), thr=Ti,
                         smin=Ti * W, a_s=3 * N, b_s=3 * M, sa=N,
                         codes=N + M, counts=8, done=Ti * W, list=Ti * Tj)
    assert buf["list"].dtype == torch.int32 and buf["sa"].dtype == torch.float32
    with pytest.raises(ValueError, match="K6 takes"):
        C._h2_buffers(2 ** 22, 2 ** 21, "meta", both=False)


def test_h2_reduce_scatter_lane_map():
    """A numpy emulation of csrc/chamfer.cu:reduce_scatter_min: after the
    five steps lane l holds the minimum over the 32 lanes of column l."""
    rng = np.random.default_rng(7)
    v = rng.random((32, 32)).astype(np.float32)     # v[lane, column]
    ref = v.min(0)
    cur = v.copy()
    s = 16
    while s >= 1:
        nxt = cur.copy()
        for lane in range(32):
            upper = bool(lane & s)
            for k in range(s):
                partner = lane ^ s
                p_upper = bool(partner & s)
                send = cur[partner, k] if p_upper else cur[partner, k + s]
                keep = cur[lane, k + s] if upper else cur[lane, k]
                nxt[lane, k] = min(keep, send)
        cur = nxt
        s //= 2
    np.testing.assert_array_equal(cur[:, 0], ref)


def test_registry():
    assert C.get_chamfer_impl("xla") is C.min_sq_dists_plain
    assert C.get_chamfer_impl("pallas") is C.min_sq_dists_brute
    h = C.get_chamfer_impl("pallas_h")
    assert h is C.min_sq_dists_h and h.pair is C.min_sq_dists_h2
    assert h.preferred_chunk == h.pair.preferred_chunk == 1024
    assert not hasattr(C.min_sq_dists_brute, "preferred_chunk")
    assert C.get_chamfer_impl("auto") is h
    try:
        C.set_default_chamfer_impl("pallas")
        assert C.get_chamfer_impl() is C.min_sq_dists_brute
    finally:
        C.set_default_chamfer_impl("auto")
    with pytest.raises(ValueError):
        C.set_default_chamfer_impl("nope")


def test_auto_follows_env(monkeypatch):
    monkeypatch.setenv("TULIP_TPU_CHAMFER", "xla")
    assert C.get_chamfer_impl() is C.min_sq_dists_plain


@pytest.mark.parametrize("pad_to", [None, 4096])
def test_chamfer_distance_matches_jax(pad_to):
    rng = np.random.default_rng(6)
    gt = _clustered(rng, 3000)
    pred = (gt[:2700] + rng.normal(0, 0.03, (2700, 3))).astype(np.float32)
    ours = TMET.chamfer_distance_async(gt, pred, pad_to=pad_to)()
    ref = JM.chamfer_distance_async(gt, pred, pad_to=pad_to)()
    a, b = _brute(gt, pred)
    assert abs(ours - (a.mean() + b.mean())) <= 1e-5 * ours
    assert abs(ours - ref) <= 1e-4 * ref


def test_cpu_path_launches_nothing_and_other_devices_raise():
    before = (C.min_sq_dists_brute.launches, C.min_sq_dists_h.launches,
              C.min_sq_dists_h2.launches)
    a = torch.rand(100, 3)
    b = torch.rand(512, 3)
    C.min_sq_dists_brute(a, b, 512)
    C.min_sq_dists_h(a, b, 512)
    C.min_sq_dists_h2(a, b, 512)
    assert (C.min_sq_dists_brute.launches, C.min_sq_dists_h.launches,
            C.min_sq_dists_h2.launches) == before
    m = torch.empty(100, 3, device="meta")
    for fn in (C.min_sq_dists_brute, C.min_sq_dists_h, C.min_sq_dists_h2):
        with pytest.raises(ValueError, match="cuda"):
            fn(m, m, 512)
    with pytest.raises(ValueError, match="multiple"):
        C.min_sq_dists_plain(a, b[:500], 512)
