"""The model variants through the port's runs on the CPU: W-axis sequence
parallel, MC dropout at a non-zero rate, and the command line.

- sequence parallel (``--sp_degree 2``): two gloo seq ranks (processes of
  their own through test_torch_dp.py:run_ranks) with Swin-v2 blocks and
  the default heads (PatchExpanding, FinalPatchExpanding) at a
  three-stage TULIP-base, 16x512 -> 64x512 (every stage keeps two window
  columns a shard): the joined fp32 eval pred within 1e-5 of max|ref| of
  the port's one process and within 1e-4 of the JAX package's unsharded
  apply_model; one fp32 train step at drop_path_rate 0.1 against one
  process: the losses within 1e-5 relative, each gradient within 1e-5 of
  its max|ref| (test_torch_sp.py's limits for a first update); dropout
  at a non-zero rate under sp > 1 is test_torch_sp_dropout.py's;
- MCdrop on two CARLA samples with dropout 0.1 (10 iterations, chunks of
  8): the iterations differ and their std is > 0; a second run with the
  same seed draws the same iterations and writes the same
  results_mcdrop.txt bit for bit, another seed draws others; at rate 0
  the full loop (TULIP_TPU_MC_FULL=1) equals the shortcut; "eval" is
  deterministic at any rate;
- the command line with ``--swin_v2`` and neither head flag on the CARLA
  fixture of test_torch_cli.py: 2 epochs, a resume to the third, --eval
  and --eval --mc_drop, with the evidence files and finite values.
"""

import builtins
import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

import test_torch_cli as CLI
from test_torch_cli import carla  # noqa: F401  (the CARLA fixture)
from test_torch_dp import TESTS, _within, run_ranks
from test_torch_eval import _Args, _Loader
from tulip_tpu_torch.config import model_config as port_config
from tulip_tpu_torch.eval import engine as TE
from tulip_tpu_torch.models import layers as TL
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.parallel import sp as SP
from tulip_tpu_torch.parallel.mesh import make_mesh, replicate
from tulip_tpu_torch.train import step as TS
from tulip_tpu_torch.utils.writer import TBWriter

CPU = torch.device("cpu")
SMALL = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
             window_size=(2, 8), circular_padding=True, log_transform=True)
HEADS = dict(pixel_shuffle=True, patch_unmerging=True)
THREE = dict(depths=(2, 2, 2), num_heads=(3, 6, 12))
SP_KW = dict(SMALL, img_size=(16, 512), target_img_size=(64, 512),
             swin_v2=True, pixel_shuffle=False, patch_unmerging=False,
             drop_path_rate=0.1, **THREE)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: several test processes share the machine's cores
    (as in test_torch_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# sequence parallel
# ---------------------------------------------------------------------------

def sp_variant(spec, rank=0, world=1):
    """This rank's W shard (all of it for world 1) of spec["x"] through
    the fp32 eval forward, joined; then one fp32 train step on its shard
    of the batch.  Returns (pred, (total, pixel) loss, gradients)."""
    mesh = make_mesh(world)
    model = TT.TULIP(port_config("tulip_base", **SP_KW))
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    replicate(model)
    x = torch.from_numpy(np.load(spec["x"]))
    with np.load(spec["batch"]) as f:
        low, high = torch.from_numpy(f["low"]), torch.from_numpy(f["high"])
    grads = []
    opt = TS.make_optimizer(model, 0.01)
    opt_step = opt.step

    def recording_step(*a, **k):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return opt_step(*a, **k)

    opt.step = recording_step
    generator = torch.Generator().manual_seed(2)
    if world == 1:
        pred = TT.apply_model(model, x, mode="eval", mc_drop=True)
        step = TS.make_train_step(model, opt, compute_dtype=torch.float32)
        loss = step(low, high, 1e-4, generator)
    else:
        pred = SP.make_sp_eval_forward(model, mesh, mode="eval")(x)
        step = SP.make_sp_train_step(model, opt, mesh,
                                     compute_dtype=torch.float32)
        loss = step(SP.shard_w(low, mesh), SP.shard_w(high, mesh), 1e-4,
                    TL.RankDraws(generator, mesh.data_index, mesh.dp))
    return pred, tuple(v.item() for v in loss), grads[0]


_RANK = """
import json, sys
import torch
import torch.distributed as td
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import test_torch_variants_runs as T
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
td.init_process_group("gloo", store=td.FileStore(spec["store"], 2),
                      rank=rank, world_size=2)
torch.save(T.sp_variant(spec, rank, 2), spec["out"] % rank)
td.destroy_process_group()
"""


def test_sp2_with_v2_and_the_default_heads(tmp_path):
    import jax.numpy as jnp
    from tulip_tpu.config import model_config
    from tulip_tpu.models import tulip as JT
    from tulip_tpu_torch.utils.checkpoint import jax_params_from_state_dict
    cfg = port_config("tulip_base", **SP_KW)
    assert SP.max_sp_degree(TT.TULIP(cfg)) == 2
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    torch.save(params, tmp_path / "params.pt")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 1, 16, 512)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.savez(tmp_path / "batch.npz",
             low=rng.uniform(0, 1, (2, 1, 16, 512)).astype(np.float32),
             high=rng.uniform(0, 1, (2, 1, 64, 512)).astype(np.float32))
    spec = dict(params=str(tmp_path / "params.pt"), x=str(tmp_path / "x.npy"),
                batch=str(tmp_path / "batch.npz"),
                store=str(tmp_path / "store"), out=str(tmp_path / "r%d.pt"))
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    run_ranks([[sys.executable, "-c", _RANK, str(r),
                str(tmp_path / "spec.json"), TESTS] for r in range(2)],
              tmp_path)
    ranks = [torch.load(spec["out"] % r, weights_only=True) for r in range(2)]
    ref, ref_loss, ref_grads = sp_variant(spec)
    jpred = np.asarray(JT.apply_model(
        {k: jnp.asarray(v) for k, v in
         jax_params_from_state_dict(params).items()},
        JT.build_model(model_config("tulip_base", **SP_KW)), jnp.asarray(x),
        mode="eval", mc_drop=True, compute_dtype=jnp.float32))
    assert torch.equal(ranks[0][0], ranks[1][0])
    for pred, loss, grads in ranks:
        assert pred.shape == ref.shape == (2, 1, 64, 512)
        assert float((pred - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
        assert np.abs(pred.numpy() - jpred).max() <= 1e-4 * np.abs(
            jpred).max()
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        _within(grads, ref_grads, 1e-5)

# ---------------------------------------------------------------------------
# MC dropout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mc_weights():
    kw = dict(SMALL, **HEADS, **THREE)
    return TT.init_params(port_config("tulip_base", **kw),
                          torch.Generator().manual_seed(0))


def _mc_run(tmp_path, weights, rate, monkeypatch, seed=0, full=False,
            chunks=None):
    """MCdrop (10 iterations) on two CARLA samples; ``chunks`` collects
    the forwards' outputs.  Returns (results, results_mcdrop.txt's
    bytes)."""
    kw = dict(SMALL, **HEADS, **THREE, drop_rate=rate, attn_drop_rate=rate)
    model = TT.TULIP(port_config("tulip_base", **kw))
    model.load_state_dict(weights)
    args = _Args("carla", (16, 256), (64, 256), str(tmp_path))
    args.seed = seed
    if chunks is not None:
        orig = TE._make_mc_forward

        def recording(*a, **k):
            fwd = orig(*a, **k)
            return lambda x, generator=None: chunks.append(
                fwd(x, generator)) or chunks[-1]

        monkeypatch.setattr(TE, "_make_mc_forward", recording)
    if full:
        monkeypatch.setenv("TULIP_TPU_MC_FULL", "1")
    out = TE.MCdrop(_Loader((16, 256), (64, 256)), model,
                    TBWriter(str(tmp_path / "tb")), args=args, device=CPU)
    monkeypatch.undo()
    text = (tmp_path / "results_mcdrop.txt").read_bytes()
    return out, text


def test_mcdrop_at_a_non_zero_rate(tmp_path, mc_weights, monkeypatch):
    chunks = []
    out, text = _mc_run(tmp_path / "a", mc_weights, 0.1, monkeypatch,
                        chunks=chunks)
    # 2 samples x ceil(10 / 8) chunks of 8, each its own draws
    assert len(chunks) == 4 and all(c.shape[0] == 8 for c in chunks)
    for s in range(2):
        preds = torch.cat(chunks[2 * s:2 * s + 2])[:10]
        assert not torch.equal(preds[0], preds[1])
        assert not torch.equal(chunks[2 * s][0], chunks[2 * s + 1][0])
        std = preds.std(0, correction=1)
        assert float(std.max()) > 0
        assert bool((std > 0.0005 * preds.mean(0)).any())   # pixels removed
    res = json.loads(text)
    assert len(res["mae"]) == 2 and all(np.isfinite(res["chamfer_dist"]))
    chunks_again, chunks_other = [], []
    _, again = _mc_run(tmp_path / "b", mc_weights, 0.1, monkeypatch,
                       chunks=chunks_again)
    assert again == text
    assert all(torch.equal(a, b) for a, b in zip(chunks, chunks_again))
    _mc_run(tmp_path / "c", mc_weights, 0.1, monkeypatch, seed=1,
            chunks=chunks_other)
    assert not any(torch.equal(a, b) for a, b in zip(chunks, chunks_other))


def test_mcdrop_at_rate_zero_full_loop_equals_the_shortcut(
        tmp_path, mc_weights, monkeypatch):
    fast, _ = _mc_run(tmp_path / "a", mc_weights, 0.0, monkeypatch)
    full, _ = _mc_run(tmp_path / "b", mc_weights, 0.0, monkeypatch,
                      full=True)
    for k in fast:
        np.testing.assert_allclose(fast[k], full[k], rtol=1e-6, err_msg=k)


def test_eval_is_deterministic_at_any_rate(mc_weights):
    low = np.random.default_rng(6).uniform(
        0, 1, (1, 1, 16, 256)).astype(np.float32)
    preds = []
    for rate in (0.0, 0.3):
        kw = dict(SMALL, **HEADS, **THREE, drop_rate=rate,
                  attn_drop_rate=rate)
        model = TT.TULIP(port_config("tulip_base", **kw))
        model.load_state_dict(mc_weights)
        preds.append(TT.apply_model(
            model, torch.from_numpy(low), mode="eval", mc_drop=True,
            generator=torch.Generator().manual_seed(0)))
    assert torch.equal(preds[0], preds[1])


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.fixture
def cli_state():
    """test_torch_cli.py's process state around main() (print, SIGTERM,
    the launcher's variables, two torch threads), for this test alone."""
    saved_print, saved_term = builtins.print, signal.getsignal(signal.SIGTERM)
    env, threads = dict(os.environ), torch.get_num_threads()
    CLI._clear_launcher_env()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    builtins.print = saved_print
    signal.signal(signal.SIGTERM, saved_term)
    os.environ.clear()
    os.environ.update(env)


def test_cli_swin_v2_with_the_default_heads(carla, tmp_path, capsys,
                                            cli_state):
    common = [a for a in CLI._common(carla)
              if a not in ("--pixel_shuffle", "--patch_unmerging")]
    common.append("--swin_v2")
    out_dir = str(tmp_path)
    CLI._main(common + CLI._train_flags(out_dir, 2))
    stats = [json.loads(l) for l in
             open(os.path.join(out_dir, "log.txt")).read().splitlines()]
    assert [s["epoch"] for s in stats] == [0, 1]
    assert all(np.isfinite(s["train_loss"]) for s in stats)
    ckpt = torch.load(os.path.join(out_dir, "checkpoint-1.pth"),
                      weights_only=True)["model"]
    assert "layers.0.blocks.0.attn.logit_scale" in ckpt
    assert "final_patch_expanding.norm.weight" in ckpt
    assert not any(k.startswith("ps_head") for k in ckpt)
    os.remove(os.path.join(out_dir, "checkpoint-0.pth"))   # 330 MB, unused
    capsys.readouterr()
    CLI._main(common + CLI._train_flags(out_dir, 3)
          + ["--resume", os.path.join(out_dir, "checkpoint-1.pth")])
    out = capsys.readouterr().out
    assert "With optim & sched!" in out and "Epoch: [2]" in out
    assert os.path.exists(os.path.join(out_dir, "checkpoint-2.pth"))
    CLI._eval(common + ["--eval", "--output_dir", out_dir, "--log_dir", out_dir])
    CLI._eval(common + ["--eval", "--mc_drop", "--noise_threshold", "0.03",
                    "--num_mcdropout_iterations", "10", "--output_dir",
                    out_dir, "--log_dir", out_dir])
    for name in ("results.txt", "results_mcdrop.txt"):
        res = json.load(open(os.path.join(out_dir, name)))
        assert set(res) == CLI.RESULT_KEYS and len(res["mae"]) == 2
        assert all(np.isfinite(v) for v in res["chamfer_dist"] + res["mae"])
