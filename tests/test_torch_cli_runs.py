"""The longer runs of the port's command line (see test_torch_cli.py, whose
synthetic CARLA folder and helpers this file shares): a resumed epoch
against the uninterrupted run, SIGTERM, the module run with ``python -m``,
and the path held against the JAX package from one checkpoint (the same
batches exactly, the first step's loss within 1e-4 relative in fp32 with
drop-path 0)."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from tulip_tpu import config as JCfg
from tulip_tpu import data as JD
from tulip_tpu.models import tulip as JT
from tulip_tpu.train import step as JS
from tulip_tpu.utils import checkpoint as JC
from tulip_tpu_torch import data as TD
from tulip_tpu_torch.config import get_args_parser, model_config
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.train import step as TS
from tulip_tpu_torch.utils import checkpoint as TC

from test_torch_cli import (REPO, _common, _main, _train_flags,  # noqa: F401
                             _restore_process_state, carla)


def test_resume_reproduces_the_uninterrupted_run(carla, tmp_path):
    """A run of three epochs, and its third epoch run again in another
    process state from its own checkpoint-1.pth: the same weights and
    moments, bit for bit (CPU, fp32: the same arithmetic in the same order;
    the data order and the drop-path draws depend on seed and epoch only)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _main(_common(carla) + _train_flags(a, 3))
    one = torch.load(os.path.join(a, "checkpoint-2.pth"), weights_only=True)
    _main(_common(carla) + _train_flags(b, 3)
          + ["--resume", os.path.join(a, "checkpoint-1.pth")])
    two = torch.load(os.path.join(b, "checkpoint-2.pth"), weights_only=True)
    for k, v in one["model"].items():
        assert torch.equal(v, two["model"][k]), k
    for k, s in one["optimizer"]["state"].items():
        assert torch.equal(s["exp_avg"], two["optimizer"]["state"][k]["exp_avg"])


def test_module_runs_with_python_m(carla, tmp_path):
    out_dir = str(tmp_path / "run")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tulip_tpu_torch.main_lidar_upsampling"]
        + _common(carla) + _train_flags(out_dir, 1), cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Training finished" in proc.stdout
    assert os.path.exists(os.path.join(out_dir, "checkpoint-0.pth"))
    stats = json.loads(open(os.path.join(out_dir, "log.txt")).read())
    assert np.isfinite(stats["train_loss"])


def test_sigterm_checkpoints_and_stops(carla, tmp_path, capsys, monkeypatch):
    """SIGTERM during an epoch: that epoch is finished, checkpointed, and
    the loop ends (save_frequency 100 would not have saved epoch 1)."""
    from tulip_tpu_torch.train import engine
    out_dir = str(tmp_path / "run")
    orig = engine.train_one_epoch

    def interrupted(step, loader, epoch, **kw):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(step, loader, epoch, **kw)

    monkeypatch.setattr(engine, "train_one_epoch", interrupted)
    flags = _train_flags(out_dir, 5)
    flags[flags.index("--save_frequency") + 1] = "100"
    _main(_common(carla) + flags)
    assert "preemption checkpoint written at epoch 1" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "checkpoint-1.pth"))
    assert not os.path.exists(os.path.join(out_dir, "checkpoint-2.pth"))
    assert len(open(os.path.join(out_dir, "log.txt")).readlines()) == 2


def test_first_step_matches_jax_from_one_checkpoint(carla, tmp_path):
    """One checkpoint written by JAX, read by both packages' load_model;
    both packages' loaders, built as their entry points build them, give
    the same first two batches exactly; the first train step's loss agrees
    within 1e-4 relative (fp32, drop-path 0, the two-stage model)."""
    kw = dict(img_size=(16, 256), target_img_size=(64, 256),
              patch_size=(1, 4), window_size=(2, 8), pixel_shuffle=True,
              circular_padding=True, log_transform=True, patch_unmerging=True,
              depths=(2, 2), num_heads=(3, 6), drop_path_rate=0.0)
    cfg = JCfg.model_config("tulip_base", **kw)
    saved = JT.init_params(jax.random.PRNGKey(3), cfg)
    path = str(tmp_path / "checkpoint-0.pth")
    JC.save_checkpoint(path, saved, None, 0, {})
    args = get_args_parser().parse_args(
        _common(carla) + ["--resume", path, "--batch_size", "2"])

    def loader(D):
        ds = D.generate_dataset(is_train=True, args=args)
        sampler = D.ShardedSampler(len(ds), num_replicas=1, rank=0,
                                   shuffle=True, seed=args.seed,
                                   drop_last=True)
        sampler.set_epoch(0)
        return D.DataLoader(ds, batch_size=2, sampler=sampler, drop_last=True,
                            num_workers=args.num_workers)

    ours, ref = iter(loader(TD)), iter(loader(JD))
    batches = []
    for _ in range(2):
        (ol, oh), (rl, rh) = next(ours), next(ref)
        assert ol["name"] == rl["name"]
        np.testing.assert_array_equal(ol["sample"], rl["sample"])
        np.testing.assert_array_equal(oh["sample"], rh["sample"])
        batches.append((ol["sample"], oh["sample"]))

    fresh = JT.init_params(jax.random.PRNGKey(0), cfg)
    jparams, _, jstart = JC.load_model(args, fresh, None)
    model = TT.TULIP(model_config("tulip_base", **kw))
    model.load_state_dict(TT.init_params(model.cfg,
                                         torch.Generator().manual_seed(0)))
    start = TC.load_model(args, model, None)
    assert start == jstart == 1
    tx = JS.make_optimizer(0.01, 1)
    jstep = JS.make_train_step(JT.build_model(cfg), tx,
                               compute_dtype=jnp.float32, donate=False)
    low, high = batches[0]
    _, (jloss, _) = jstep(JS.init_train_state(jparams, tx), jnp.asarray(low),
                          jnp.asarray(high), np.float32(1e-4),
                          jax.random.PRNGKey(0))
    step = TS.make_train_step(model, TS.make_optimizer(model, 0.01),
                              compute_dtype=torch.float32)
    loss, _ = step(torch.from_numpy(low), torch.from_numpy(high), 1e-4)
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
