"""Data parallel in the port (parallel/{dist,mesh}.py, train/step.py,
models/layers.py:RankDraws) on the CPU: two gloo ranks in processes of
their own, over a FileStore under tmp_path, one torch thread each.

At the small config of test_torch_train.py (a two-stage TULIP-base,
16x256 -> 64x256), fp32:

- (a) 2 ranks x batch 1 against one process x batch 2 on the joined batch,
  drop_path_rate 0.1, accum_iter 1 (2 steps) and 2 (4 micro-steps): the
  losses within 1e-5 relative; the gradient of the first update within
  1e-5 of each tensor's max|ref| (the same arithmetic but for the order of
  the batch's sums; measured <= 4.1e-7); the weights, and the gradients of
  later updates, within 1e-5 of the largest |ref| of all tensors
  (measured 3.6e-8 and 6.5e-7).  Per tensor these would not hold: a
  tensor that starts at zero, a bias, holds entries of about lr after one
  update, and AdamW's normalised update turns the rounding noise of a
  gradient entry near zero into up to 2e-4 of that; the next gradient of
  a tensor as small as a bias table's (1.6e-6) then moves by 2e-3 of
  itself, as it does between one process's runs on 1 and on 2 threads.
  The two ranks' weights are equal bit for bit after every step (rank 1
  starts from other weights, which replicate() overwrites);
- (b) the same two ranks at drop-path 0 against the JAX package's one
  process on the joined batch (``make_train_step``): the first loss within
  1e-5 relative and each gradient within 1e-4 of its max|ref|, the limits
  of test_torch_train.py:test_fp32_loss_and_every_gradient_match_jax; the
  weights within that file's AdamW limits (_check_moves);
- (d) in-process: a rank's drop-path rows are the rows of the global draw,
  a world of 1 draws today's bits, the samplers' strides are disjoint and
  cover the epoch, and --mesh_shape must name the world size.

Every spawned rank has a time limit, and when one fails the others are
killed: a rank that exits alone leaves the rest waiting in a collective.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tulip_tpu_torch.config import model_config
from tulip_tpu_torch.data.pipeline import ShardedSampler
from tulip_tpu_torch.models import layers as L
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.parallel import dist
from tulip_tpu_torch.parallel.mesh import check_mesh_shape, replicate
from tulip_tpu_torch.train import step as TS

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
KW = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True, depths=(2, 2),
          num_heads=(3, 6))
LR, WD = 1e-4, 0.01
RANK_TIMEOUT = 300


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def train_steps(spec, rank=0, world=1):
    """``spec["steps"]`` fp32 train steps of the port, as rank ``rank`` of
    ``world``: each joined batch of ``spec["batches"]`` is cut in ``world``
    equal row blocks and this rank takes block ``rank``; the drop-path
    draws come from one generator seeded ``spec["seed"]``.  Returns
    (per step: (total, pixel) losses and the weights; the gradients AdamW
    was handed, one dict a weight update; rows drop-path zeroed).  The
    dropout rates are spec["drop_rate"] / spec["attn_drop_rate"] (0 when
    absent)."""
    cfg = model_config("tulip_base", drop_path_rate=spec["rate"],
                       drop_rate=spec.get("drop_rate", 0.0),
                       attn_drop_rate=spec.get("attn_drop_rate", 0.0), **KW)
    model = TT.TULIP(cfg)
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    if rank > 0:
        with torch.no_grad():   # replicate() must overwrite these
            for p in model.parameters():
                p.add_(1.0)
    replicate(model)
    opt = TS.make_optimizer(model, WD)
    grads, dropped = [], [0]
    opt_step, drop_path = opt.step, L.drop_path

    def recording_step(*a, **k):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return opt_step(*a, **k)

    def counting_drop_path(x, rate, generator, active):
        y = drop_path(x, rate, generator, active)
        if y is not x:
            dropped[0] += int((y.reshape(y.shape[0], -1) == 0).all(1).sum())
        return y

    opt.step = recording_step
    L.drop_path = counting_drop_path
    step = TS.make_train_step(model, opt, accum_iter=spec["accum_iter"],
                              compute_dtype=torch.float32)
    with np.load(spec["batches"]) as f:
        batches = {k: f[k] for k in ("low", "high")}
    generator = torch.Generator().manual_seed(spec["seed"])
    draws = generator if world == 1 else L.RankDraws(generator, rank, world)
    out = []
    try:
        for i in range(spec["steps"]):
            low, high = (batches[k][i % len(batches["low"])]
                         for k in ("low", "high"))
            b = low.shape[0] // world
            rows = slice(rank * b, (rank + 1) * b)
            total, pixel = step(torch.from_numpy(low[rows]),
                                torch.from_numpy(high[rows]), LR, draws)
            out.append(dict(loss=(total.item(), pixel.item()),
                            weights={n: p.detach().clone()
                                     for n, p in model.named_parameters()}))
    finally:
        L.drop_path = drop_path
    return out, grads, dropped[0]


_RANK = """
import json, sys
import torch
import torch.distributed as td
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import test_torch_dp as T
from tulip_tpu_torch.parallel import dist
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
td.init_process_group("gloo", store=td.FileStore(spec["store"], 2),
                      rank=rank, world_size=2)
assert (dist.get_rank(), dist.get_world_size()) == (rank, 2)
torch.save(T.train_steps(spec, rank, 2), spec["out"] % rank)
td.destroy_process_group()
"""


def run_ranks(argvs, tmp_path, envs=None, timeout=RANK_TIMEOUT,
              on_poll=None):
    """Start one process per argv (with ``envs[r]`` over this process's
    environment), stdout / stderr in files under tmp_path; wait for all of
    them, killing the rest as soon as one fails or the time limit passes.
    ``on_poll(procs)`` is called while they run.  Returns their stdout
    texts."""
    base = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    files, procs = [], []
    for r, argv in enumerate(argvs):
        out = open(tmp_path / f"rank{r}.out", "w+")
        err = open(tmp_path / f"rank{r}.err", "w+")
        files.append((out, err))
        env = dict(base, **(envs[r] if envs else {}))
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=out,
                                      stderr=err, text=True))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad or "time limit"
                break
            if on_poll is not None:
                on_poll(procs)
            time.sleep(0.1)
        failed = failed or [r for r, p in enumerate(procs) if p.returncode]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    assert not failed, (failed, [e[-3000:] for _, e in texts])
    return [o for o, _ in texts]


def two_ranks(tmp_path, spec):
    spec = dict(spec, store=str(tmp_path / "store"),
                out=str(tmp_path / "rank%d.pt"))
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    run_ranks([[sys.executable, "-c", _RANK, str(r), str(path), TESTS]
               for r in range(2)], tmp_path)
    return [torch.load(spec["out"] % r, weights_only=True) for r in range(2)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Weights of the small config (the port's init) and two joined batches
    of 2, in files the ranks read."""
    root = tmp_path_factory.mktemp("dp")
    cfg = model_config("tulip_base", **KW)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    torch.save(params, root / "params.pt")
    rng = np.random.default_rng(0)
    np.savez(root / "batches.npz",
             low=rng.uniform(0, 1, (2, 2, 1, 16, 256)).astype(np.float32),
             high=rng.uniform(0, 1, (2, 2, 1, 64, 256)).astype(np.float32))
    return dict(params=str(root / "params.pt"),
                batches=str(root / "batches.npz"))


def _one_process(spec):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return train_steps(spec)
    finally:
        torch.set_num_threads(threads)


def _within(got, ref, limit, per_tensor=True):
    """Each tensor's largest difference over its largest |ref|, or over the
    largest |ref| of all of them."""
    top = max(float(v.abs().max()) for v in ref.values())
    errs = {k: float((got[k] - ref[k]).abs().max()
                     / (ref[k].abs().max().clamp_min(1e-30) if per_tensor
                        else top)) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= limit, (worst, errs[worst])


# ---------------------------------------------------------------------------
# (a) two ranks against one process, the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum_iter", [1, 2])
def test_two_ranks_equal_one_process_on_the_joined_batch(data, tmp_path,
                                                         accum_iter):
    spec = dict(data, rate=0.1, seed=2, accum_iter=accum_iter,
                steps=2 * accum_iter)
    ranks = two_ranks(tmp_path, spec)
    ref, ref_grads, ref_dropped = _one_process(spec)
    # the draws zeroed some rows, so the rows each rank keeps matter
    assert ref_dropped > 0
    assert ranks[0][2] + ranks[1][2] == ref_dropped
    assert len(ref_grads) == len(ranks[0][1]) == 2
    for i, want in enumerate(ref):
        got0, got1 = ranks[0][0][i], ranks[1][0][i]
        for k, w in got0["weights"].items():
            assert torch.equal(w, got1["weights"][k]), (i, k)
        assert got0["loss"] == got1["loss"]
        np.testing.assert_allclose(got0["loss"], want["loss"], rtol=1e-5)
        _within(got0["weights"], want["weights"], 1e-5, per_tensor=False)
    for j, (got, want) in enumerate(zip(ranks[0][1], ref_grads)):
        _within(got, want, 1e-5, per_tensor=j == 0)
    # the weights moved by about lr a step, far beyond the limit
    params = torch.load(data["params"], weights_only=True)
    assert max(float((ref[-1]["weights"][k] - params[k]).abs().max())
               for k in params) >= 0.5 * LR


def test_a_group_of_one_rank_changes_no_bit(data, tmp_path, monkeypatch):
    """In a group of one rank (gloo here; the command line under a launcher
    of world 1) the step runs its reduction, one all_reduce a step (the
    small config's gradients and the two losses fit one bucket), and
    computes the bits of the run without a group."""
    import torch.distributed as td
    spec = dict(data, rate=0.1, seed=2, accum_iter=1, steps=2)
    ref = _one_process(spec)
    calls = []
    all_reduce = td.all_reduce
    monkeypatch.setattr(td, "all_reduce", lambda t, *a, **k: (
        calls.append(t.numel()), all_reduce(t, *a, **k))[1])
    td.init_process_group("gloo", store=td.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = _one_process(spec)
    finally:
        td.destroy_process_group()
    n_params = sum(p.numel() for p in torch.load(
        data["params"], weights_only=True).values())
    assert len(calls) == 2 and calls[0] == n_params + 2
    for a, b in zip(got[0], ref[0]):
        assert a["loss"] == b["loss"]
        for k, w in b["weights"].items():
            assert torch.equal(a["weights"][k], w), k


# ---------------------------------------------------------------------------
# (b) two ranks against the JAX package's one process
# ---------------------------------------------------------------------------

def test_two_ranks_match_the_jax_step_on_the_joined_batch(tmp_path):
    import jax
    import jax.numpy as jnp
    from tulip_tpu.config import model_config as jax_model_config
    from tulip_tpu.models import tulip as JT
    from tulip_tpu.train import step as JS
    from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                  state_dict_from_jax)
    from test_torch_train import _check_moves

    cfg = jax_model_config("tulip_base", drop_path_rate=0.0, **KW)
    params = {k: np.asarray(v) for k, v in
              JT.init_params(jax.random.PRNGKey(0), cfg).items()}
    torch.save(state_dict_from_jax(params), tmp_path / "params.pt")
    rng = np.random.default_rng(1)
    low = rng.uniform(0, 1, (2, 2, 1, 16, 256)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 2, 1, 64, 256)).astype(np.float32)
    np.savez(tmp_path / "batches.npz", low=low, high=high)
    spec = dict(params=str(tmp_path / "params.pt"),
                batches=str(tmp_path / "batches.npz"), rate=0.0, seed=0,
                accum_iter=1, steps=2)
    ranks = two_ranks(tmp_path, spec)

    jmodel = JT.build_model(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def loss_fn(p):
        return JT.apply_model(p, jmodel, jnp.asarray(low[0]),
                              jnp.asarray(high[0]), mode="train",
                              rng=jax.random.PRNGKey(1),
                              compute_dtype=jnp.float32)[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    tx = JS.make_optimizer(WD, 1)
    jstep = JS.make_train_step(jmodel, tx, compute_dtype=jnp.float32,
                               donate=False)
    state = JS.init_train_state(jparams, tx)
    for i in range(2):
        state, (total, _) = jstep(state, jnp.asarray(low[i]),
                                  jnp.asarray(high[i]), np.float32(LR),
                                  jax.random.PRNGKey(i))
        if i == 0:
            assert float(total) == pytest.approx(float(jloss), rel=1e-6)
        got = ranks[0][0][i]
        ours = jax_params_from_state_dict(got["weights"])
        _check_moves(ours, {k: np.asarray(v)
                            for k, v in state.params.items()}, i + 1)
        assert jax_params_from_state_dict(ranks[1][0][i]["weights"]).keys() \
            == ours.keys()
    assert abs(ranks[0][0][0]["loss"][0] - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    grads = jax_params_from_state_dict(ranks[0][1][0])
    assert set(grads) == set(jgrads)
    errs = {k: float(np.abs(grads[k] - np.asarray(jgrads[k])).max()
                     / np.abs(np.asarray(jgrads[k])).max()) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


# ---------------------------------------------------------------------------
# (d) in-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_rank_rows_are_the_rows_of_the_global_draw(world):
    """Each rank's keep mask is its block of the mask one process draws on
    the joined batch, and the generators stay in step."""
    b, rate = 3, 0.5
    x = torch.randn(world * b, 4, 2, 5, generator=torch.Generator()
                    .manual_seed(1)) + 3.0
    gens = [torch.Generator().manual_seed(7) for _ in range(world + 1)]
    for _ in range(3):    # three draws in a row: the generators in step
        want = L.drop_path(x, rate, gens[world], True)
        for r in range(world):
            got = L.drop_path(x[r * b:(r + 1) * b], rate,
                              L.RankDraws(gens[r], r, world), True)
            assert torch.equal(got, want[r * b:(r + 1) * b])
    assert all(torch.equal(g.get_state(), gens[world].get_state())
               for g in gens)
    kept = (want.reshape(world * b, -1) != 0).all(1)
    assert 0 < int(kept.sum()) < world * b


def test_world_of_one_draws_todays_bits():
    """A world of 1, with or without RankDraws, draws exactly what the
    per-sample mask drew before data parallel: torch.rand((B, 1, 1, 1))."""
    x = torch.randn(5, 3, 4, 6, generator=torch.Generator().manual_seed(0))
    keep = 0.8
    mask = torch.rand((5, 1, 1, 1),
                      generator=torch.Generator().manual_seed(3)) < keep
    today = torch.where(mask, x / keep, torch.zeros(()))
    for g in (torch.Generator().manual_seed(3),
              L.RankDraws(torch.Generator().manual_seed(3), 0, 1)):
        assert torch.equal(L.drop_path(x, 1 - keep, g, True), today)


@pytest.mark.parametrize("n,world", [(6, 2), (7, 2), (10, 4), (5, 1)])
def test_sampler_strides_are_disjoint_and_cover_the_epoch(n, world):
    """drop_last (the train sampler): the ranks' strides are disjoint and
    together the first world x (n // world) of the epoch's permutation; the
    same epoch gives the same order on every rank, another epoch another."""
    def strides(epoch):
        out = []
        for r in range(world):
            s = ShardedSampler(n, num_replicas=world, rank=r, shuffle=True,
                               seed=0, drop_last=True)
            s.set_epoch(epoch)
            out.append(list(s))
        return out

    for epoch in (0, 1):
        ranks = strides(epoch)
        assert all(len(s) == n // world for s in ranks)
        joined = [i for s in ranks for i in s]
        assert len(set(joined)) == len(joined)
        perm = np.random.default_rng(epoch).permutation(n)
        assert sorted(joined) == sorted(perm[:world * (n // world)])
        # batch 1 a rank: step k of the ranks is the one process's step k
        # of batch world, in rank order
        assert [ranks[r][k] for k in range(n // world)
                for r in range(world)] == list(perm[:world * (n // world)])
    assert strides(0) != strides(1)


def test_mesh_shape_must_name_the_world_size():
    assert dist.get_world_size() == 1
    check_mesh_shape(None)
    check_mesh_shape([1])
    check_mesh_shape([1, 1])     # (data, seq) = (world // 1, 1)
    for shape in ([4], [2], [1, 2]):
        with pytest.raises(ValueError, match="1 rank"):
            check_mesh_shape(shape)


def test_without_a_group_the_reductions_are_the_identity():
    t = [torch.ones(3), torch.arange(4.0)]
    before = [x.clone() for x in t]
    dist.average_(t)
    dist.broadcast_(t)
    dist.barrier()
    assert all(torch.equal(a, b) for a, b in zip(t, before))
    assert dist.all_reduce_mean(2.5) == 2.5
    assert (dist.get_rank(), dist.get_world_size(), dist.get_num_devices(),
            dist.is_main_process()) == (0, 1, 1, True)


@pytest.mark.parametrize("cap", [1 << 20, 64])
def test_buckets_cut_runs_of_one_dtype_and_device(cap):
    ts = [torch.zeros(10), torch.zeros(20), torch.zeros(3, dtype=torch.float64),
          torch.zeros(5), torch.zeros(100)]
    runs = list(dist._buckets(ts, cap))
    assert [t for run in runs for t in run] == ts
    for run in runs:
        assert len({(t.dtype, t.device) for t in run}) == 1
        assert (len(run) == 1
                or sum(t.numel() * t.element_size() for t in run) <= cap)
    assert len(runs) == (3 if cap > 1000 else 5)
