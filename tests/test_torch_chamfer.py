"""The port's nearest-neighbour sweeps (tulip_tpu_torch.ops.chamfer) against
the JAX package's K7 / K6 / K5 (Pallas, interpret mode on the CPU) and a
numpy brute force, the K5 / K6 tables against JAX's, and the tables' skip
rule replayed in torch.

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
        s, r = C._tile_bounds(torch.from_numpy(sorted_pts), tile)
        js, jr = JH._tile_bounds(jnp.asarray(sorted_pts), tile)
        # a mean in two libraries: summation order only
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5)
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


def _replay(a, b, chunk, pair, tile):
    """The kernels' walk over the plan, in order on the CPU: K6 stops at the
    first chunk whose bound reaches the tile's worst minimum; K5 skips a
    chunk unless its bound is below the tile's or the chunk's worst minimum.
    Returns (d_a, d_b or None, chunks visited, chunks in all)."""
    pa, pb, a_s, b_s, lb_sorted, order = C.plan(
        a, b, chunk, tile=tile, bounds="box" if pair else "sphere")
    N, M = a.shape[0], b.shape[0]
    da = torch.full((N,), 1e30)
    db = torch.full((M,), 1e30)
    visits = 0
    for i in range(lb_sorted.shape[0]):
        rows = slice(i * tile, min((i + 1) * tile, N))
        for k in range(lb_sorted.shape[1]):
            lb = lb_sorted[i, k]
            cols = slice(int(order[i, k]) * chunk, (int(order[i, k]) + 1)
                         * chunk)
            cur_a = da[rows].max()
            if pair and not (lb < cur_a or lb < db[cols].max()):
                continue
            if not pair and k > 0 and lb >= cur_a:
                break
            d = C.min_sq_dists_plain(a_s[rows], b_s[cols], chunk)
            da[rows] = torch.minimum(da[rows], d)
            if pair:
                db[cols] = torch.minimum(
                    db[cols], C._min_sq_dists(b_s[cols], a_s[rows], chunk))
            visits += 1
    d_a = C._unsort(da, pa)
    d_b = C._unsort(db, pb) if pair else None
    return d_a, d_b, visits, lb_sorted.numel()


@pytest.mark.parametrize("pair", [False, True])
def test_skip_rule_is_exact(pair):
    """Replaying the tables with the kernels' skip rule gives the brute
    minima exactly and skips work on a scan-like cloud (small tiles, so that
    this size has tile pairs to skip; the rule does not depend on them)."""
    rng = np.random.default_rng(5)
    a = _clustered(rng, 3000)
    b = np.concatenate([(a[:2800] + rng.normal(0, 0.05, (2800, 3)))
                        .astype(np.float32),
                        np.full((272, 3), 1e8, np.float32)])
    ref_a, ref_b = _brute(a, b[:2800])
    d_a, d_b, visits, total = _replay(torch.from_numpy(a),
                                      torch.from_numpy(b), 256, pair, 128)
    np.testing.assert_allclose(d_a.numpy(), ref_a, rtol=1e-6, atol=1e-6)
    if pair:
        np.testing.assert_allclose(d_b.numpy()[:2800], ref_b, rtol=1e-6,
                                   atol=1e-6)
    assert visits < total


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
