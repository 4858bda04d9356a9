"""The model variants in training and with dropout active, against the JAX
package on the CPU (fp32; the port runs its plain versions, JAX its XLA
path, whose Swin-v2 and dropout compositions reach no Pallas kernel).

- gradients: the loss's gradient against jax.grad of JAX's apply_model
  (mode "train", drop-path and dropout off) for v2 with the flagship
  heads (two stages), v1 and v2 with the default heads (three: a decoder
  stage with its PatchExpanding), TULIP-base at 16x256 -> 64x256: the loss
  within 1e-5 relative, each parameter within 1e-4 of its max|ref| (the
  limit of test_torch_train.py);
- dropout sites: (i) in modes "train" and "mc" the port's draws match the
  JAX package's (attn_impl "xla", whose attention draws per window, as the
  port's composition does) in order, element count and rate, for v1 and
  v2 (v2 has pos_drop only); (ii) one numpy mask injected at pos_drop into
  both packages, every other site kept: the fp32 forwards within 1e-5;
  (iii) at every site the zeroed share lies within 4 sigma of the rate and
  the survivors are x / (1 - rate) exactly; a data-parallel rank draws its
  rows of the global batch's mask; (iv) rate 1e-9 in "mc" (the keep
  probability rounds to 1 in fp32, so nothing drops in either package)
  equals JAX's "eval" within 1e-5: the plumbing alone;
- data parallel: two gloo ranks of batch 1 (processes of their own,
  through test_torch_dp.py:run_ranks), every dropout site and drop-path at
  0.1, against one process on the joined batch of 2: the losses within
  1e-5 relative, the first update's gradient within 1e-4 of each
  parameter's max|ref|, the ranks' weights equal bit for bit.

MC dropout at a non-zero rate, sequence parallel and the command line are
in test_torch_variants_runs.py.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import layers as JL
from tulip_tpu.models import tulip as JT
from tulip_tpu_torch.config import model_config as port_config
from tulip_tpu_torch.models import layers as TL
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                              load_jax_params)

SMALL = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
             window_size=(2, 8), circular_padding=True, log_transform=True)
HEADS = dict(pixel_shuffle=True, patch_unmerging=True)
DEFAULT_HEADS = dict(pixel_shuffle=False, patch_unmerging=False)
THREE = dict(depths=(2, 2, 2), num_heads=(3, 6, 12))
TWO = dict(depths=(2, 2), num_heads=(3, 6))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: several test processes share the machine's cores
    (as in test_torch_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_pair(kw, **jax_kw):
    cfg = model_config("tulip_base", **kw, **jax_kw)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    model = TT.TULIP(port_config("tulip_base", **kw))
    load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    return cfg, params, model


def _batch(seed, n=2, low=(16, 256), high=(64, 256)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 1) + low).astype(np.float32),
            rng.uniform(0, 1, (n, 1) + high).astype(np.float32))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swin_v2,heads,stages", [
    (True, HEADS, TWO), (False, DEFAULT_HEADS, THREE),
    (True, DEFAULT_HEADS, THREE)])
def test_loss_and_every_gradient_match_jax(swin_v2, heads, stages):
    """Three stages where the decoder has a PatchExpanding upsample."""
    cfg, params, model = make_pair(dict(SMALL, swin_v2=swin_v2, **heads,
                                        **stages, drop_path_rate=0.0))
    low, high = _batch(0)

    def loss_fn(p):
        return JT.apply_model(p, JT.build_model(cfg), jnp.asarray(low),
                              jnp.asarray(high), mode="train",
                              rng=jax.random.PRNGKey(1),
                              compute_dtype=jnp.float32)[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    _, total, _ = TT.apply_model(model, torch.from_numpy(low),
                                 torch.from_numpy(high), mode="train")
    total.backward()
    assert abs(total.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = jax_params_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    assert set(grads) == set(jgrads)
    errs = {k: float(np.abs(grads[k] - np.asarray(jgrads[k])).max()
                     / np.abs(np.asarray(jgrads[k])).max()) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


# ---------------------------------------------------------------------------
# dropout sites
# ---------------------------------------------------------------------------

def _record(module, calls, inject=None):
    """Wrap ``module.dropout``: record (elements, rate) of each call that
    draws; ``inject(x, rate, index)`` may replace the draw of a call."""
    orig = module.dropout

    def wrapped(x, rate, draws, active, *grid):
        if not (active and rate > 0 and draws is not None):
            return orig(x, rate, draws, active, *grid)
        calls.append((int(np.prod(x.shape)), rate))
        if inject is not None:
            return inject(x, rate, len(calls) - 1)
        return orig(x, rate, draws, active, *grid)

    return orig, wrapped


@pytest.mark.parametrize("mode", ["train", "mc"])
@pytest.mark.parametrize("swin_v2", [False, True])
def test_dropout_sites_match_jax(monkeypatch, swin_v2, mode):
    kw = dict(SMALL, swin_v2=swin_v2, **HEADS, **TWO, drop_rate=0.1,
              attn_drop_rate=0.2)
    cfg, params, model = make_pair(kw, attn_impl="xla")
    low, _ = _batch(1)
    jcalls, tcalls = [], []
    monkeypatch.setattr(JL, "dropout", _record(JL, jcalls)[1])
    JT.apply_model(params, JT.build_model(cfg), jnp.asarray(low), mode=mode,
                   mc_drop=True, rng=jax.random.PRNGKey(1))
    monkeypatch.setattr(TL, "dropout", _record(TL, tcalls)[1])
    TT.apply_model(model, torch.from_numpy(low), mode=mode, mc_drop=True,
                   generator=torch.Generator().manual_seed(0))
    # pos_drop, then per v1 block attn (0.2), proj, fc1, fc2 (0.1)
    assert len(jcalls) == (1 if swin_v2 else 1 + 4 * 6)
    assert tcalls == jcalls


@pytest.mark.parametrize("swin_v2", [False, True])
def test_one_mask_at_pos_drop_gives_jax_forward(monkeypatch, swin_v2):
    """The same numpy keep mask at pos_drop in both packages (the first
    site of both, (B, H, W, C) in both); the later sites pass their input
    through; the fp32 forwards agree within 1e-5 of max|ref|."""
    kw = dict(SMALL, swin_v2=swin_v2, **HEADS, **TWO, drop_rate=0.5)
    cfg, params, model = make_pair(kw, attn_impl="xla")
    low, _ = _batch(2)
    mask = np.random.default_rng(3).uniform(0, 1, (2, 16, 64, 96)) < 0.5

    def jax_inject(x, rate, i):
        if i:
            return x
        return jnp.where(jnp.asarray(mask), x / (1 - rate), 0.0).astype(
            x.dtype)

    def torch_inject(x, rate, i):
        if i:
            return x
        return torch.where(torch.from_numpy(mask), x / (1 - rate),
                           torch.zeros(()))

    jcalls, tcalls = [], []
    monkeypatch.setattr(JL, "dropout", _record(JL, jcalls, jax_inject)[1])
    jpred = np.asarray(JT.apply_model(
        params, JT.build_model(cfg), jnp.asarray(low), mode="mc",
        mc_drop=True, rng=jax.random.PRNGKey(1), compute_dtype=jnp.float32))
    monkeypatch.setattr(TL, "dropout", _record(TL, tcalls, torch_inject)[1])
    pred = TT.apply_model(model, torch.from_numpy(low), mode="mc",
                          mc_drop=True,
                          generator=torch.Generator().manual_seed(0))
    assert tcalls[0] == jcalls[0] == (mask.size, 0.5)
    assert np.abs(pred.numpy() - jpred).max() <= 1e-5 * np.abs(jpred).max()
    # and the mask mattered: without it the forward is another one
    free = TT.apply_model(model, torch.from_numpy(low), mode="eval",
                          mc_drop=True)
    assert float((free - pred).abs().max()) > 1e-2 * float(pred.abs().max())


def test_every_site_drops_its_rate_and_scales_the_survivors(monkeypatch):
    kw = dict(SMALL, **HEADS, **TWO, drop_rate=0.1, attn_drop_rate=0.2)
    model = TT.TULIP(port_config("tulip_base", **kw))
    model.load_state_dict(TT.init_params(model.cfg,
                                         torch.Generator().manual_seed(0)))
    orig = TL.dropout
    seen = []

    def checked(x, rate, draws, active, *grid):
        y = orig(x, rate, draws, active, *grid)
        if active and rate > 0 and draws is not None:
            live = x != 0
            n = int(live.sum())
            zeroed = int((y[live] == 0).sum()) / n
            sigma = math.sqrt(rate * (1 - rate) / n)
            assert abs(zeroed - rate) <= 4 * sigma, (x.shape, rate, zeroed)
            kept = y != 0
            assert torch.equal(y[kept], x[kept] / (1 - rate))
            seen.append(rate)
        return y

    monkeypatch.setattr(TL, "dropout", checked)
    low, high = _batch(4)
    TT.apply_model(model, torch.from_numpy(low), torch.from_numpy(high),
                   mode="train", generator=torch.Generator().manual_seed(1))
    # pos_drop, then four sites in each of the six blocks
    assert sorted(set(seen)) == [0.1, 0.2] and len(seen) == 1 + 4 * 6


def test_a_rank_draws_its_rows_of_the_global_mask():
    """Each site's first axis is batch-major (samples, windows or tokens
    by sample): a RankDraws rank's mask is its block of the one-process
    mask, and the generators stay in step."""
    x = torch.rand(6, 4, 5, 7, generator=torch.Generator().manual_seed(0))
    x = x + 1.0
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    for _ in range(2):
        want = TL.dropout(x, 0.3, gens[2], True)
        for r in range(2):
            got = TL.dropout(x[3 * r:3 * r + 3], 0.3,
                             TL.RankDraws(gens[r], r, 2), True)
            assert torch.equal(got, want[3 * r:3 * r + 3])
    assert all(torch.equal(g.get_state(), gens[2].get_state()) for g in gens)
    assert TL.dropout(x, 0.3, None, True) is x
    assert TL.dropout(x, 0.0, gens[0], True) is x
    assert TL.dropout(x, 0.3, gens[0], False) is x


@pytest.mark.parametrize("swin_v2", [False, True])
def test_a_rate_that_rounds_to_keep_all_equals_jax_eval(swin_v2):
    kw = dict(SMALL, swin_v2=swin_v2, **HEADS, **TWO, drop_rate=1e-9,
              attn_drop_rate=1e-9)
    cfg, params, model = make_pair(kw)
    low, _ = _batch(5)
    jpred = np.asarray(JT.apply_model(
        params, JT.build_model(cfg), jnp.asarray(low), mode="eval",
        mc_drop=True, compute_dtype=jnp.float32))
    pred = TT.apply_model(model, torch.from_numpy(low), mode="mc",
                          mc_drop=True,
                          generator=torch.Generator().manual_seed(0))
    assert np.abs(pred.numpy() - jpred).max() <= 1e-5 * np.abs(jpred).max()


# ---------------------------------------------------------------------------
# data parallel with dropout
# ---------------------------------------------------------------------------

DROPOUT = dict(SMALL, **HEADS, **TWO, drop_rate=0.1, attn_drop_rate=0.1,
               drop_path_rate=0.1)


def dropout_steps(spec, rank=0, world=1):
    """Two fp32 train steps of the port with every dropout site and
    drop-path at 0.1, as rank ``rank`` of ``world`` on its rows of each
    joined batch, the draws from one generator seeded spec["seed"].
    Returns (per step: losses and weights; the first update's gradient)."""
    from tulip_tpu_torch.parallel.mesh import replicate
    from tulip_tpu_torch.train import step as TS
    model = TT.TULIP(port_config("tulip_base", **DROPOUT))
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    replicate(model)
    opt = TS.make_optimizer(model, 0.01)
    grads, opt_step = [], opt.step

    def recording_step(*a, **k):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return opt_step(*a, **k)

    opt.step = recording_step
    step = TS.make_train_step(model, opt, compute_dtype=torch.float32)
    with np.load(spec["batches"]) as f:
        low, high = f["low"], f["high"]
    generator = torch.Generator().manual_seed(spec["seed"])
    draws = generator if world == 1 else TL.RankDraws(generator, rank, world)
    out = []
    for i in range(2):
        b = low.shape[1] // world
        rows = slice(rank * b, (rank + 1) * b)
        total, pixel = step(torch.from_numpy(low[i, rows]),
                            torch.from_numpy(high[i, rows]), 1e-4, draws)
        out.append(dict(loss=(total.item(), pixel.item()),
                        weights={n: p.detach().clone()
                                 for n, p in model.named_parameters()}))
    return out, grads[0]


_RANK = """
import json, sys
import torch
import torch.distributed as td
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import test_torch_variants_train as T
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
td.init_process_group("gloo", store=td.FileStore(spec["store"], 2),
                      rank=rank, world_size=2)
torch.save(T.dropout_steps(spec, rank, 2), spec["out"] % rank)
td.destroy_process_group()
"""


def test_two_ranks_with_dropout_equal_one_process(tmp_path):
    import json
    import sys
    from test_torch_dp import TESTS, _within, run_ranks
    params = TT.init_params(port_config("tulip_base", **DROPOUT),
                            torch.Generator().manual_seed(0))
    torch.save(params, tmp_path / "params.pt")
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "batches.npz",
             low=rng.uniform(0, 1, (2, 2, 1, 16, 256)).astype(np.float32),
             high=rng.uniform(0, 1, (2, 2, 1, 64, 256)).astype(np.float32))
    spec = dict(params=str(tmp_path / "params.pt"),
                batches=str(tmp_path / "batches.npz"), seed=3,
                store=str(tmp_path / "store"), out=str(tmp_path / "r%d.pt"))
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    run_ranks([[sys.executable, "-c", _RANK, str(r),
                str(tmp_path / "spec.json"), TESTS] for r in range(2)],
              tmp_path)
    ranks = [torch.load(spec["out"] % r, weights_only=True) for r in range(2)]
    ref, ref_grads = dropout_steps(spec)
    for i, want in enumerate(ref):
        got0, got1 = ranks[0][0][i], ranks[1][0][i]
        assert got0["loss"] == got1["loss"]
        for k, w in got0["weights"].items():
            assert torch.equal(w, got1["weights"][k]), (i, k)
        np.testing.assert_allclose(got0["loss"], want["loss"], rtol=1e-5)
    _within(ranks[0][1], ref_grads, 1e-4)
    # the draws reached the loss: another seed gives another one
    other, _ = dropout_steps(dict(spec, seed=4))
    assert other[0]["loss"] != ref[0]["loss"]
