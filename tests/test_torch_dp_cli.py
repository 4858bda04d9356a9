"""The port's command line under two ranks (``--device cpu``: gloo, a
``file://`` rendezvous under tmp_path, one torch thread a rank), on the
synthetic CARLA folder of test_torch_cli.py (six training scans):

- two ranks of ``--batch_size 1`` for three epochs against one process of
  ``--batch_size 2`` (the same samples in the same steps: with batch 1 a
  rank, step k of the two strides is the one process's step k): one
  ``log.txt``, one TensorBoard file and one set of checkpoints, written by
  rank 0 alone; rank 1 prints nothing after the group's start-up; the
  losses within 1e-5 relative and the final weights within 1e-5 of the
  model's max|w| (see test_torch_dp.py for why not per tensor);
- the third epoch resumed under two ranks from the run's checkpoint-1.pth
  equal to the uninterrupted run bit for bit (weights and moments);
- ``--eval`` under two ranks: each rank evaluates its stride of the two
  val scans, and rank 0 alone writes results.txt, over its own scan (the
  reference's rank-0 quirk, SURVEY.md:197-200);
- SIGTERM to rank 1 alone: both ranks stop after the same epoch, and rank 0
  writes the preemption checkpoint.
"""

import json
import os
import signal
import sys

import pytest
import torch

from test_torch_cli import (_common, _main, _restore_process_state,  # noqa
                            _train_flags, carla)
from test_torch_dp import run_ranks

MODULE = [sys.executable, "-m", "tulip_tpu_torch.main_lidar_upsampling"]


def _flags(carla, out_dir, epochs, batch):
    flags = _common(carla) + _train_flags(out_dir, epochs)
    flags[flags.index("--batch_size") + 1] = str(batch)
    return flags


def _two_ranks(tmp_path, name, flags, on_poll=None):
    """The command line as ranks 0 and 1 of a launcher's world of 2 (this
    process's launcher variables are cleared by _restore_process_state)."""
    run_dir = tmp_path / f"ranks_{name}"
    run_dir.mkdir()
    argv = MODULE + flags + ["--dist_url", f"file://{run_dir / 'init'}"]
    envs = [dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r))
            for r in range(2)]
    return run_ranks([argv, argv], run_dir, envs=envs, on_poll=on_poll)


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _ckpt(out_dir, epoch):
    return torch.load(os.path.join(out_dir, f"checkpoint-{epoch}.pth"),
                      weights_only=True)


def test_two_ranks_train_like_one_process_and_resume(carla, tmp_path):
    ranks_dir, one_dir, resumed = (str(tmp_path / d)
                                   for d in ("ranks", "one", "resumed"))
    out = _two_ranks(tmp_path, "train", _flags(carla, ranks_dir, 3, 1))
    assert "Start training" in out[0] and "Epoch: [2]" in out[0]
    assert "distributed init (rank 1)" in out[1]
    assert "Start training" not in out[1] and "Epoch:" not in out[1]
    log = _log(ranks_dir)
    assert [e["epoch"] for e in log] == [0, 1, 2]
    assert len([f for f in os.listdir(ranks_dir)
                if f.startswith("events.out.tfevents")]) == 1
    assert sorted(f for f in os.listdir(ranks_dir) if f.endswith(".pth")) \
        == [f"checkpoint-{e}.pth" for e in range(3)]
    ckpt = _ckpt(ranks_dir, 2)
    assert ckpt["args"]["batch_size"] == 1 and ckpt["args"]["distributed"]

    # one process, batch 2: the same samples in the same steps
    _main(_flags(carla, one_dir, 3, 2))
    for got, want in zip(log, _log(one_dir)):
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
    ref = _ckpt(one_dir, 2)["model"]
    top = max(float(v.abs().max()) for v in ref.values())
    worst = max(float((ckpt["model"][k] - v).abs().max())
                for k, v in ref.items())
    assert worst <= 1e-5 * top
    moved = max(float((_ckpt(one_dir, 0)["model"][k] - v).abs().max())
                for k, v in ref.items())
    assert moved >= 100 * worst

    # the third epoch again, under two ranks, from checkpoint-1.pth
    out = _two_ranks(tmp_path, "resume", _flags(carla, resumed, 3, 1) + [
        "--resume", os.path.join(ranks_dir, "checkpoint-1.pth")])
    assert "With optim & sched!" in out[0] and "Epoch: [1]" not in out[0]
    assert [e["epoch"] for e in _log(resumed)] == [2]
    again = _ckpt(resumed, 2)
    for k, v in ckpt["model"].items():
        assert torch.equal(v, again["model"][k]), k
    for k, s in ckpt["optimizer"]["state"].items():
        assert torch.equal(s["exp_avg"],
                           again["optimizer"]["state"][k]["exp_avg"])


def test_eval_under_two_ranks_writes_rank_0s_results(carla, tmp_path):
    run = str(tmp_path / "run")
    _main(_flags(carla, run, 1, 2))
    out = _two_ranks(tmp_path, "eval", _common(carla) + [
        "--eval", "--output_dir", run, "--log_dir", run])
    assert "Evaluation finished" in out[0] and "Evaluation" not in out[1]
    res = json.load(open(os.path.join(run, "results.txt")))
    assert set(res) == {"mae", "chamfer_dist", "iou", "precision", "recall",
                        "f1"}
    assert all(len(v) == 1 for v in res.values())   # rank 0's one scan


def test_sigterm_to_one_rank_stops_both(carla, tmp_path):
    """SIGTERM reaches rank 1 only, once epoch 0 is logged: the flag is
    reduced over the ranks at each epoch's end, so both leave the loop
    after the same epoch (alone, rank 0 would wait in the next epoch's
    first all-reduce until the time limit) and rank 0 checkpoints it."""
    out_dir = str(tmp_path / "run")
    flags = _flags(carla, out_dir, 20, 1)
    flags[flags.index("--save_frequency") + 1] = "100"
    sent = []

    def signal_rank_1(procs):
        if not sent and os.path.exists(os.path.join(out_dir, "log.txt")):
            procs[1].send_signal(signal.SIGTERM)
            sent.append(True)

    out = _two_ranks(tmp_path, "sigterm", flags, on_poll=signal_rank_1)
    assert sent
    last = _log(out_dir)[-1]["epoch"]
    assert last < 19
    assert f"preemption checkpoint written at epoch {last}" in out[0]
    assert os.path.exists(os.path.join(out_dir, f"checkpoint-{last}.pth"))
    assert "Training finished" in out[0]
