"""Dropout at a non-zero rate under W-axis sequence parallel in the port
(models/layers.py:RankDraws with a seq shard and the sites' grids,
parallel/sp.py:seq_draws, the v1 block's dropout composition on a W
shard, eval/engine.py:MCdrop's sharded forward) on the CPU: gloo ranks in
processes of their own, spawned through test_torch_sp.py:ranks.

At the small config of test_torch_dp.py (a two-stage TULIP-base,
16x256 -> 64x256, whose token grids 16x64 and 8x32 take sp 2), fp32. The
semantics are the unsharded ones: dp x sp ranks draw the masks one
process draws on the whole batch and the whole scan.

- draws: in both layouts (tokens (B, H, W, C) and (B·H·W, C); windows
  (B·nWh·nWw, ...) of a scan rolled by (0, 0) and by (1, 2) through the
  halo exchange), at sp 2 and 4 and at dp 2 x sp 2, a rank's mask is its
  rows and W columns of one process's, bit for bit; the shard's windows
  after the roll are the rolled scan's windows at its window columns; the
  generators stay in step; a draw across W shards needs its site's grid;
  without seq shards the grid draws today's bits;
- forward: two seq ranks in mode "mc" at (drop, attn_drop) = (0.1, 0),
  (0, 0.2) and (0.1, 0.2): the joined pred within 1e-5 of max|ref| of one
  process's on the same generator, the ranks bit-equal;
- step: two seq ranks at drop-path 0.1 and dropout 0.1 / 0.2, and dp 2 x
  sp 2 on four ranks at 0.1 / 0.1, against one process on the joined
  batch, with test_torch_sp.py:_check_step's limits;
- MCdrop at rate 0.1 (the full loop) through make_sp_eval_forward on two
  seq ranks against one process: preds within 1e-5 of max|ref|, results
  within 1e-5 relative, rank 0 alone writing results_mcdrop.txt;
- against JAX: with dropout the identity at every site of both packages,
  the sharded port forward in "mc" (v1 and v2) visits the JAX package's
  sites in its order (global elements, rate) and equals its unsharded
  apply_model within 1e-4 of max.
"""

import numpy as np
import pytest
import torch

from test_torch_dp import KW, _one_process
from test_torch_sp import _check_step, data, ranks  # noqa: F401 (fixture)
from tulip_tpu_torch.config import model_config
from tulip_tpu_torch.models import layers as L
from tulip_tpu_torch.models import swin as S
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.parallel import halo
from tulip_tpu_torch.parallel import sp as SP
from tulip_tpu_torch.parallel.mesh import Mesh, make_mesh

MODULE = "test_torch_sp_dropout"


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def shard_draws(spec, rank, world):
    """This rank's dropout at rate 0.3 on its rows and W shard of seeded
    float64 tensors (ones and above, so that a zero is a dropped element)
    against one process's on the whole tensors, for every layout.
    Returns (the checks that failed, the share of elements dropped)."""
    mesh = make_mesh(spec["sp"])
    dp, sp, d, s = mesh.dp, mesh.sp, mesh.data_index, mesh.seq_index
    B, H, Wl, C, nh, (wh, ww) = 2, 4, 8, 3, 2, (2, 4)
    nWh, nWl = H // wh, Wl // ww
    g = torch.Generator().manual_seed(0)
    X = 1.0 + torch.rand(dp * B, H, Wl * sp, C, generator=g,
                         dtype=torch.float64)
    rows, cols = slice(d * B, (d + 1) * B), slice(s * Wl, (s + 1) * Wl)
    x = X[rows, :, cols]
    one = torch.Generator().manual_seed(7)
    draws = L.RankDraws(torch.Generator().manual_seed(7), d, dp, s, sp)
    whole, grid = (dp * B, H, Wl * sp), (B, H, Wl)
    bad, dropped = [], []

    def check(name, got, want):
        if not torch.equal(got, want):
            bad.append(name)
        dropped.append(float((got == 0).double().mean()))

    def mine(t):
        """The rank's windows of a tensor of the whole scan's windows."""
        t = t.reshape(dp * B, nWh, nWl * sp, *t.shape[1:])
        return t[rows, :, s * nWl:(s + 1) * nWl].reshape(-1, *t.shape[3:])

    want = L.dropout(X, 0.3, one, True, whole)
    check("tokens", L.dropout(x, 0.3, draws, True, grid), want[rows, :, cols])
    want = L.dropout(X.reshape(-1, C), 0.3, one, True, whole)
    got = L.dropout(x.reshape(-1, C), 0.3, draws, True, grid)
    check("tokens (B·H·W, C)", got.reshape(x.shape),
          want.reshape(X.shape)[rows, :, cols])
    ring = mesh.ring()
    for sh, sw in ((0, 0), (1, 2)):
        with halo.sequence_axis(ring):
            xw = S.window_partition(halo.roll_hw(x, -sh, -sw), wh, ww)
        XW = S.window_partition(torch.roll(X, (-sh, -sw), (1, 2)), wh, ww)
        if not torch.equal(xw, mine(XW)):
            bad.append(f"windows of the scan rolled by {(sh, sw)}")
        want = L.dropout(XW, 0.3, one, True, (dp * B, nWh, nWl * sp))
        got = L.dropout(xw, 0.3, draws, True, (B, nWh, nWl))
        check(f"windows {(sh, sw)}", got, mine(want))
        A = 1.0 + torch.rand(XW.shape[0], nh, wh * ww, wh * ww, generator=g,
                             dtype=torch.float64)
        check(f"attention {(sh, sw)}",
              L.dropout(mine(A), 0.3, draws, True, (B, nWh, nWl)),
              mine(L.dropout(A, 0.3, one, True, (dp * B, nWh, nWl * sp))))
        with halo.sequence_axis(ring):
            back = halo.roll_hw(S.window_reverse(got, wh, ww, H, Wl), sh, sw)
        full = torch.roll(S.window_reverse(want, wh, ww, H, Wl * sp),
                          (sh, sw), (1, 2))
        check(f"windows {(sh, sw)} back in tokens", back,
              full[rows, :, cols])
    if not torch.equal(draws.generator.get_state(), one.get_state()):
        bad.append("the generators left step")
    return bad, min(dropped)


def _model(spec):
    cfg = model_config("tulip_base", swin_v2=spec.get("swin_v2", False),
                       drop_rate=spec["drop_rate"],
                       attn_drop_rate=spec["attn_drop_rate"], **KW)
    model = TT.TULIP(cfg)
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    return model


def mc_forward(spec, rank, world):
    """The fp32 "mc" forward of this rank's W shard of spec["x"], its
    dropout from a generator seeded spec["seed"], gathered: (the joined
    pred, the exchange count)."""
    fwd = SP.make_sp_eval_forward(_model(spec), make_mesh(world), mode="mc",
                                  compute_dtype=torch.float32)
    x = torch.from_numpy(np.load(spec["x"]))
    return (fwd(x, torch.Generator().manual_seed(spec["seed"])),
            halo.exchanges())


def identity_sites(spec, rank, world):
    """mc_forward with the port's dropout the identity: (the joined pred,
    (the global elements, rate) of each site that would draw)."""
    calls = []

    def identity(x, rate, draws, active, grid=None):
        if active and rate > 0 and draws is not None:
            calls.append((x.numel() * draws.world * draws.n_seq, rate))
        return x

    L.dropout = identity
    pred, _ = mc_forward(spec, rank, world)
    return pred, calls


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,sp", [(1, 2), (1, 4), (2, 2)])
def test_a_shards_draw_is_its_slice_of_one_process_draw(tmp_path, dp, sp):
    out = ranks(tmp_path, dict(module=MODULE, fn="shard_draws",
                               world=dp * sp, sp=sp))
    for bad, dropped in out:
        assert bad == []
        assert dropped > 0.1


def test_a_draw_across_w_shards_needs_its_sites_grid():
    x = torch.ones(2, 4, 8, 3)
    draws = L.RankDraws(torch.Generator().manual_seed(0), 0, 1, 1, 2)
    with pytest.raises(ValueError, match="grid"):
        L.dropout(x, 0.3, draws, True)
    # drop-path's per-sample mask has no W axis, and needs no grid
    y = L.drop_path(x, 0.5, draws, True)
    assert y.shape == x.shape


def test_without_seq_shards_the_grid_draws_todays_bits():
    """A grid changes nothing where no W is sharded: one process, and a
    data rank's rows of the global batch, draw what they drew without it."""
    x = 1.0 + torch.rand(6, 4, 8, 5, generator=torch.Generator()
                         .manual_seed(1))
    for draws in (lambda: torch.Generator().manual_seed(3),
                  lambda: L.RankDraws(torch.Generator().manual_seed(3), 1,
                                      2)):
        for grid in ((6, 4, 8), (6, 2, 2)):
            assert torch.equal(L.dropout(x, 0.4, draws(), True, grid),
                               L.dropout(x, 0.4, draws(), True))


def test_the_sharded_forward_adds_the_seq_shard_to_its_draws():
    ring = Mesh(2, 4, 6).ring()
    g = torch.Generator()
    assert SP.seq_draws(None, ring) is None
    assert SP.seq_draws(g, ring) == L.RankDraws(g, 0, 1, 2, 4)
    assert SP.seq_draws(L.RankDraws(g, 1, 2), ring) == \
        L.RankDraws(g, 1, 2, 2, 4)


# ---------------------------------------------------------------------------
# the forward, the step, MCdrop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop,attn_drop", [(0.1, 0.0), (0.0, 0.2),
                                            (0.1, 0.2)])
def test_mc_forward_of_two_seq_ranks_equals_one_process(data, tmp_path,
                                                        drop, attn_drop):
    spec = dict(data, drop_rate=drop, attn_drop_rate=attn_drop, seed=5)
    out = ranks(tmp_path, dict(spec, module=MODULE, fn="mc_forward",
                               world=2))
    model = _model(spec)
    x = torch.from_numpy(np.load(data["x"]))
    ref = TT.apply_model(model, x, mode="mc", mc_drop=True,
                         generator=torch.Generator().manual_seed(5))
    free = TT.apply_model(model, x, mode="eval", mc_drop=True)
    # the masks mattered
    assert float((ref - free).abs().max()) > 1e-2 * float(ref.abs().max())
    for pred, n in out:
        assert pred.shape == ref.shape == (2, 1, 64, 256)
        # 3 shifted blocks x 2 rolls + the pad
        assert n == 7
        assert float((pred - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    assert torch.equal(out[0][0], out[1][0])


def test_step_with_dropout_of_two_seq_ranks_equals_one_process(data,
                                                               tmp_path):
    spec = dict(data, rate=0.1, seed=2, accum_iter=1, steps=2, sp=2,
                drop_rate=0.1, attn_drop_rate=0.2)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=2))
    _check_step(got, _one_process(spec), spec, 2)
    # the dropout composition rolls as the kernels' path does
    assert got[0][3] == got[1][3] == 2 * 13


def test_dp2_sp2_with_dropout_on_four_ranks_equals_one_process(data,
                                                               tmp_path):
    spec = dict(data, batches=data["batches4"], rate=0.1, seed=3,
                accum_iter=2, steps=2, sp=2, drop_rate=0.1,
                attn_drop_rate=0.1)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=4))
    _check_step(got, _one_process(spec), spec, 1)


def test_mcdrop_at_rate_0_1_of_two_seq_ranks_equals_one_process(data,
                                                                tmp_path):
    from test_torch_sp import sp_mcdrop
    spec = dict(data, out_dir=str(tmp_path / "mc%d"), drop_rate=0.1,
                attn_drop_rate=0.1)
    out = ranks(tmp_path, dict(spec, fn="sp_mcdrop", world=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref, ref_preds, _ = sp_mcdrop(
            dict(spec, out_dir=str(tmp_path / "one%d")), 0, 1)
    finally:
        torch.set_num_threads(threads)
    # the full loop: ceil(10 / 8) chunks of 8 a sample, iterations differ
    assert len(ref_preds) == 4
    assert not torch.equal(ref_preds[0][0], ref_preds[0][1])
    for res, preds, n in out:
        assert len(preds) == 4 and n == 7 * 4
        for p, r in zip(preds, ref_preds):
            assert p.shape == r.shape == (8, 1, 64, 256)
            assert float((p - r).abs().max()) <= 1e-5 * float(r.abs().max())
        assert set(res) == set(ref)
        for k, v in ref.items():
            assert len(res[k]) == len(v) == 2
            np.testing.assert_allclose(res[k], v, rtol=1e-5, err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert (tmp_path / "mc0" / "results_mcdrop.txt").exists()
    assert not (tmp_path / "mc1" / "results_mcdrop.txt").exists()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swin_v2", [False, True])
def test_sharded_sites_follow_jax_and_the_forward_equals_jax(tmp_path,
                                                             monkeypatch,
                                                             swin_v2):
    import jax
    import jax.numpy as jnp
    from tulip_tpu.config import model_config as jax_model_config
    from tulip_tpu.models import layers as JL
    from tulip_tpu.models import tulip as JT
    from tulip_tpu_torch.utils.checkpoint import jax_params_from_state_dict

    kw = dict(KW, swin_v2=swin_v2, drop_rate=0.1, attn_drop_rate=0.2)
    params = TT.init_params(model_config("tulip_base", **kw),
                            torch.Generator().manual_seed(1))
    torch.save(params, tmp_path / "params.pt")
    x = np.random.default_rng(4).uniform(0, 1, (2, 1, 16, 256)).astype(
        np.float32)
    np.save(tmp_path / "x.npy", x)
    spec = dict(params=str(tmp_path / "params.pt"), x=str(tmp_path / "x.npy"),
                swin_v2=swin_v2, drop_rate=0.1, attn_drop_rate=0.2, seed=0)
    out = ranks(tmp_path, dict(spec, module=MODULE, fn="identity_sites",
                               world=2))

    jcalls = []

    def identity(x, rate, rng, active):
        if active and rate > 0 and rng is not None:
            jcalls.append((int(np.prod(x.shape)), rate))
        return x

    monkeypatch.setattr(JL, "dropout", identity)
    jpred = np.asarray(JT.apply_model(
        {k: jnp.asarray(v) for k, v in
         jax_params_from_state_dict(params).items()},
        # the xla attention draws per window, as the port does (the
        # grouped one, JAX's CPU default, over groups of windows)
        JT.build_model(jax_model_config("tulip_base", attn_impl="xla", **kw)),
        jnp.asarray(x), mode="mc", mc_drop=True, rng=jax.random.PRNGKey(1),
        compute_dtype=jnp.float32))
    # pos_drop, then per v1 block attn (0.2), proj, fc1, fc2 (0.1)
    assert len(jcalls) == (1 if swin_v2 else 1 + 4 * 6)
    for pred, calls in out:
        assert calls == jcalls
        assert np.abs(pred.numpy() - jpred).max() <= 1e-4 * np.abs(
            jpred).max()
    assert torch.equal(out[0][0], out[1][0])
