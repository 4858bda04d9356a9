"""The port's command line under W-axis sequence parallel (``--sp_degree``,
``--device cpu``: gloo, a ``file://`` rendezvous under tmp_path, one torch
thread a rank) on a synthetic CARLA folder at 8x512 -> 32x512 with
window 1x4 (token grids 8x128 ... 1x16: every stage keeps two window
columns on each of 2 shards, where TULIP-base at 16x256 with window 2x8
takes no W sharding at all; 32x512 keeps the metric step's clouds at the
16,384 points of test_torch_cli.py):

- two ranks of ``--sp_degree 4``, clamped to 2 with the JAX entry's
  message, for two epochs against one process: one ``log.txt``, one
  TensorBoard file and one set of checkpoints, from rank 0; rank 1 prints
  nothing after the group's start-up; the losses within 1e-5 relative and
  the weights within 1e-5 of the model's max|w| (test_torch_dp_cli.py's
  limits); the second epoch resumed under two ranks from checkpoint-0.pth
  equal to the uninterrupted run bit for bit (weights and moments);
- ``--eval --sp_degree 2`` under two ranks: both ranks run every val scan's
  forward on their shard, rank 0 alone writes results.txt, over the whole
  val set, within 1e-5 of the one-process eval's;
- in one process (a world of 1): ``--sp_degree`` above the cap is clamped
  with the message, and a degree that does not divide the world raises
  ValueError.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_cli import (_main, _restore_process_state,  # noqa: F401
                            _write_rimg)
from test_torch_dp import run_ranks

MODULE = [sys.executable, "-m", "tulip_tpu_torch.main_lidar_upsampling"]
CLAMPED = ("--sp_degree 4 exceeds this model geometry's ceiling (every "
           "stage needs >= 2 window columns per W shard); clamping to 2")


@pytest.fixture(scope="module")
def carla(tmp_path_factory):
    root = tmp_path_factory.mktemp("carla512")
    rng = np.random.default_rng(0)
    for town in ("Town01", "Town02", "Town03", "Town04", "Town05", "Town06",
                 "Town07", "Town10HD"):
        for res, shape in (("8_512", (8, 512)), ("32_512", (32, 512))):
            d = root / town / res
            d.mkdir(parents=True)
            _write_rimg(str(d / "0000.rimg"),
                        rng.uniform(2.5, 79.0, shape).astype(np.float32))
    return str(root)


def _common(root):
    return ["--model_select", "tulip_base", "--pixel_shuffle",
            "--circular_padding", "--patch_unmerging", "--log_transform",
            "--dataset_select", "carla", "--img_size_low_res", "8", "512",
            "--img_size_high_res", "32", "512", "--window_size", "1", "4",
            "--patch_size", "1", "4", "--in_chans", "1", "--num_workers", "2",
            "--wandb_disabled", "--data_path_low_res", root,
            "--data_path_high_res", root, "--device", "cpu"]


def _train(root, out_dir, epochs, save_frequency=1):
    """Training flags; a checkpoint is 326 MB (weights and AdamW moments),
    so runs that need only their last one save only that."""
    return _common(root) + [
        "--batch_size", "2", "--epochs", str(epochs), "--warmup_epochs", "1",
        "--lr", "1e-4", "--weight_decay", "0.01", "--save_frequency",
        str(save_frequency), "--output_dir", out_dir, "--log_dir", out_dir,
        "--precision", "fp32"]


def _drop_checkpoints(tmp_path):
    for f in glob.glob(str(tmp_path / "**" / "*.pth"), recursive=True):
        os.remove(f)


def _two_ranks(tmp_path, name, flags):
    run_dir = tmp_path / f"ranks_{name}"
    run_dir.mkdir()
    argv = MODULE + flags + ["--dist_url", f"file://{run_dir / 'init'}"]
    envs = [dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r))
            for r in range(2)]
    return run_ranks([argv, argv], run_dir, envs=envs)


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _ckpt(out_dir, epoch):
    return torch.load(os.path.join(out_dir, f"checkpoint-{epoch}.pth"),
                      weights_only=True)


def test_two_seq_ranks_train_like_one_process_and_resume(carla, tmp_path):
    ranks_dir, one_dir, resumed = (str(tmp_path / d)
                                   for d in ("ranks", "one", "resumed"))
    out = _two_ranks(tmp_path, "train", _train(carla, ranks_dir, 2)
                     + ["--sp_degree", "4"])
    assert CLAMPED in out[0] and "Epoch: [1]" in out[0]
    assert "distributed init (rank 1)" in out[1]
    assert "Start training" not in out[1] and "Epoch:" not in out[1]
    log = _log(ranks_dir)
    assert [e["epoch"] for e in log] == [0, 1]
    assert len([f for f in os.listdir(ranks_dir)
                if f.startswith("events.out.tfevents")]) == 1
    assert sorted(f for f in os.listdir(ranks_dir) if f.endswith(".pth")) \
        == ["checkpoint-0.pth", "checkpoint-1.pth"]
    ckpt = _ckpt(ranks_dir, 1)
    assert ckpt["args"]["sp_degree"] == 2 and ckpt["args"]["distributed"]

    # one process, the same batches of 2 whole scans
    _main(_train(carla, one_dir, 2, save_frequency=100))
    for got, want in zip(log, _log(one_dir)):
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
    ref = _ckpt(one_dir, 1)["model"]
    top = max(float(v.abs().max()) for v in ref.values())
    worst = max(float((ckpt["model"][k] - v).abs().max())
                for k, v in ref.items())
    assert worst <= 1e-5 * top
    first = _ckpt(ranks_dir, 0)["model"]
    moved = max(float((first[k] - v).abs().max()) for k, v in ref.items())
    assert moved >= 100 * worst

    # the second epoch again, under two seq ranks, from checkpoint-0.pth
    out = _two_ranks(tmp_path, "resume", _train(carla, resumed, 2) + [
        "--sp_degree", "2", "--resume",
        os.path.join(ranks_dir, "checkpoint-0.pth")])
    assert "With optim & sched!" in out[0] and "Epoch: [0]" not in out[0]
    assert [e["epoch"] for e in _log(resumed)] == [1]
    again = _ckpt(resumed, 1)
    for k, v in ckpt["model"].items():
        assert torch.equal(v, again["model"][k]), k
    for k, s in ckpt["optimizer"]["state"].items():
        assert torch.equal(s["exp_avg"],
                           again["optimizer"]["state"][k]["exp_avg"])
    _drop_checkpoints(tmp_path)


def test_eval_under_two_seq_ranks_equals_one_process(carla, tmp_path):
    run, one = str(tmp_path / "run"), str(tmp_path / "one")
    _main(_train(carla, run, 1))
    with pytest.raises(SystemExit) as e:
        _main(_common(carla) + ["--eval", "--output_dir", run,
                                "--log_dir", one])
    assert e.value.code == 0
    os.makedirs(one, exist_ok=True)
    os.replace(os.path.join(run, "results.txt"),
               os.path.join(one, "results.txt"))
    out = _two_ranks(tmp_path, "eval", _common(carla) + [
        "--eval", "--sp_degree", "2", "--output_dir", run, "--log_dir",
        run])
    assert "Evaluation finished" in out[0] and "Evaluation" not in out[1]
    got = json.load(open(os.path.join(run, "results.txt")))
    want = json.load(open(os.path.join(one, "results.txt")))
    assert set(got) == set(want) == {"mae", "chamfer_dist", "iou",
                                     "precision", "recall", "f1"}
    assert all(len(v) == 2 for v in got.values())   # the whole val set
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    _drop_checkpoints(tmp_path)


@pytest.mark.parametrize("degree,clamped", [("4", True), ("2", False),
                                            ("3", True)])
def test_degree_is_clamped_and_must_divide_the_world(carla, tmp_path, capsys,
                                                     degree, clamped):
    """A world of 1: --sp_degree above the cap (2 here) is clamped with the
    JAX entry's message, and the degree then left, 2, does not divide 1."""
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        _main(_train(carla, str(tmp_path / "run"), 1)
              + ["--sp_degree", degree])
    said = capsys.readouterr().out
    assert (f"--sp_degree {degree} exceeds this model geometry's ceiling"
            in said) == clamped
