"""The port's command line (tulip_tpu_torch.main_lidar_upsampling) driven
as bash_scripts/*.sh drive the reference, on a synthetic CARLA folder
(16x256 -> 64x256, the smallest width TULIP-base's four stages take), on
the CPU: train 2 epochs -> checkpoints -> resume to 3 -> --eval from the
directory and from the .pth -> --eval --mc_drop; and the device, launcher
(the process group) and --mesh_shape rules (--sp_degree:
test_torch_sp_cli.py).  The longer runs (resume against an
uninterrupted run, SIGTERM, ``python -m``, the first step against the JAX
package) are in test_torch_cli_runs.py, a file of its own so that the two
run side by side."""

import builtins
import glob
import json
import os
import shlex
import signal

import numpy as np
import pytest
import torch

from tulip_tpu import config as JCfg
from tulip_tpu_torch import main_lidar_upsampling as M
from tulip_tpu_torch.config import get_args_parser
from tulip_tpu_torch.parallel import mesh as TMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_KEYS = {"mae", "chamfer_dist", "iou", "precision", "recall", "f1"}


def _write_rimg(path, img):
    """CARLA .rimg: (H, W) uint64 header + fp16 payload stored as (W, H)."""
    H, W = img.shape
    with open(path, "wb") as f:
        np.array([H, W], dtype=np.uint64).tofile(f)
        np.flip(img).astype(np.float16).T.tofile(f)


@pytest.fixture(scope="module")
def carla(tmp_path_factory):
    root = tmp_path_factory.mktemp("carla")
    rng = np.random.default_rng(0)
    train = ["Town01", "Town02", "Town03", "Town04", "Town05", "Town06"]
    for town in train + ["Town07", "Town10HD"]:
        for res, shape in (("16_256", (16, 256)), ("64_256", (64, 256))):
            d = root / town / res
            d.mkdir(parents=True)
            for i in range(1):
                _write_rimg(str(d / f"{i:04d}.rimg"),
                            rng.uniform(2.5, 79.0, shape).astype(np.float32))
    return str(root)


LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
                 "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                 "OMPI_COMM_WORLD_LOCAL_RANK", "TULIP_TPU_MULTIHOST")


def _clear_launcher_env():
    """main() reads the launcher's variables; an earlier test of the same
    process may have left some behind (discover_launcher_env exports RANK
    and WORLD_SIZE under --dist_on_itp), and with them main() would take
    itself for a rank that exits."""
    for k in LAUNCHER_VARS:
        os.environ.pop(k, None)


@pytest.fixture(autouse=True)
def _restore_process_state():
    """main() patches print (timestamps) and takes SIGTERM: put both back.
    The runs take two torch threads: several test processes share the
    machine's cores, and full-width thread pools in each of them spend
    their time waiting on one another."""
    saved_print, saved_term = builtins.print, signal.getsignal(signal.SIGTERM)
    env, threads = dict(os.environ), torch.get_num_threads()
    _clear_launcher_env()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
    builtins.print = saved_print
    signal.signal(signal.SIGTERM, saved_term)
    os.environ.clear()
    os.environ.update(env)


def _common(root):
    return ["--model_select", "tulip_base", "--pixel_shuffle",
            "--circular_padding", "--patch_unmerging", "--log_transform",
            "--dataset_select", "carla", "--img_size_low_res", "16", "256",
            "--img_size_high_res", "64", "256", "--window_size", "2", "8",
            "--patch_size", "1", "4", "--in_chans", "1", "--num_workers", "2",
            "--wandb_disabled", "--data_path_low_res", root,
            "--data_path_high_res", root, "--device", "cpu"]


def _train_flags(out_dir, epochs):
    return ["--batch_size", "2", "--epochs", str(epochs), "--warmup_epochs",
            "1", "--lr", "1e-4", "--weight_decay", "0.01", "--save_frequency",
            "1", "--output_dir", out_dir, "--log_dir", out_dir, "--precision",
            "fp32"]


def _main(argv):
    args = get_args_parser().parse_args(argv)
    if args.output_dir and not args.eval:
        os.makedirs(args.output_dir, exist_ok=True)
    M.main(args)
    return args


def _eval(argv):
    with pytest.raises(SystemExit) as e:
        _main(argv)
    assert e.value.code == 0


@pytest.fixture(scope="module")
def trained(carla, tmp_path_factory):
    """Two epochs of batch 2 through main(): the run the other tests resume
    and evaluate."""
    out_dir = str(tmp_path_factory.mktemp("run"))
    saved = (builtins.print, signal.getsignal(signal.SIGTERM),
             torch.get_num_threads())
    torch.set_num_threads(2)
    _clear_launcher_env()
    try:
        _main(_common(carla) + _train_flags(out_dir, 2))
    finally:
        builtins.print = saved[0]
        signal.signal(signal.SIGTERM, saved[1])
        torch.set_num_threads(saved[2])
    return out_dir


def test_train_writes_checkpoints_and_log(trained):
    assert os.path.exists(os.path.join(trained, "checkpoint-0.pth"))
    assert os.path.exists(os.path.join(trained, "checkpoint-1.pth"))
    lines = open(os.path.join(trained, "log.txt")).read().splitlines()
    assert len(lines) == 2
    stats = [json.loads(l) for l in lines]
    assert [s["epoch"] for s in stats] == [0, 1]
    assert all(np.isfinite(s["train_loss"]) for s in stats)
    assert set(stats[0]) == {"train_lr", "train_loss", "epoch"}
    ckpt = torch.load(os.path.join(trained, "checkpoint-1.pth"),
                      weights_only=True)
    assert ckpt["epoch"] == 1 and ckpt["args"]["batch_size"] == 2
    assert glob.glob(os.path.join(trained, "events.out.tfevents.*"))


def test_resume_continues_at_the_next_epoch(trained, carla, capsys):
    args = _main(_common(carla) + _train_flags(trained, 3)
                 + ["--resume", os.path.join(trained, "checkpoint-1.pth")])
    out = capsys.readouterr().out
    assert "Resume checkpoint" in out and "With optim & sched!" in out
    assert "Epoch: [2]" in out and "Epoch: [1]" not in out
    assert args.start_epoch == 2
    assert os.path.exists(os.path.join(trained, "checkpoint-2.pth"))
    lines = open(os.path.join(trained, "log.txt")).read().splitlines()
    assert [json.loads(l)["epoch"] for l in lines] == [0, 1, 2]


@pytest.mark.parametrize("target", ["directory", "pth"])
def test_eval_resolves_the_checkpoint(trained, carla, capsys, target):
    """--output_dir at a directory takes its latest checkpoint; at a .pth
    that file, and its directory for results.txt (main:117-124)."""
    where = (trained if target == "directory"
             else os.path.join(trained, "checkpoint-0.pth"))
    results = os.path.join(trained, "results.txt")
    if os.path.exists(results):
        os.remove(results)
    _eval(_common(carla) + ["--eval", "--output_dir", where, "--log_dir",
                            trained])
    out = capsys.readouterr().out
    latest = max(glob.glob(os.path.join(trained, "checkpoint-*.pth")),
                 key=lambda p: int(p.split("-")[-1].split(".")[0]))
    want = latest if target == "directory" else where
    assert f"Resume checkpoint {want}" in out
    assert "With optim & sched!" not in out and "Evaluation finished" in out
    res = json.load(open(results))
    assert set(res) == RESULT_KEYS
    assert all(len(v) == 2 for v in res.values())      # Town07 + Town10HD
    assert all(np.isfinite(v) for v in res["chamfer_dist"] + res["mae"])


def test_eval_mc_drop(trained, carla):
    _eval(_common(carla) + ["--eval", "--mc_drop", "--noise_threshold", "0.03",
                            "--num_mcdropout_iterations", "10", "--output_dir",
                            trained, "--log_dir", trained])
    res = json.load(open(os.path.join(trained, "results_mcdrop.txt")))
    assert set(res) == RESULT_KEYS and len(res["mae"]) == 2
    assert all(np.isfinite(v) for v in res["chamfer_dist"])


def test_default_device_needs_a_gpu(carla, tmp_path, monkeypatch):
    """--device defaults to cuda; where there is no GPU main() raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _common(carla) if a not in ("--device", "cpu")]
    assert get_args_parser().parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        _main(argv + _train_flags(str(tmp_path / "run"), 1))
    with pytest.raises(ValueError, match="cuda or cpu"):
        M._device("meta")
    assert M._device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("shape", [["4"], ["2"], ["1", "2"]])
def test_mesh_shape_other_than_the_world_size_raises(carla, tmp_path, shape):
    """--mesh_shape names the one data axis of the group or its (data,
    seq) layout: without a launcher, a world of 1 (so [1] or [1, 1])."""
    with pytest.raises(ValueError, match="1 rank"):
        _main(_common(carla) + _train_flags(str(tmp_path / "run"), 1)
              + ["--mesh_shape", *shape])


def test_mesh_shape_of_the_world_and_multihost_train(carla, tmp_path,
                                                     monkeypatch):
    """--mesh_shape 1 (the world without a launcher) and
    TULIP_TPU_MULTIHOST=1 (one group in torch, whatever the hosts) ask for
    nothing more: the run trains."""
    monkeypatch.setenv("TULIP_TPU_MULTIHOST", "1")
    out_dir = str(tmp_path / "run")
    _main(_common(carla) + _train_flags(out_dir, 1) + ["--mesh_shape", "1"])
    assert os.path.exists(os.path.join(out_dir, "checkpoint-0.pth"))


def test_launcher_joins_a_group(monkeypatch, tmp_path):
    """Under a launcher (world 1 included) the process joins a group at
    --dist_url: gloo for --device cpu; nccl on cuda:LOCAL_RANK for --device
    cuda, the device deciding.  Without one, no group."""
    import torch.distributed as td
    args = get_args_parser().parse_args(["--device", "cpu"])
    TMesh.init_distributed_mode(args)
    assert (args.rank, args.world_size, args.distributed, args.gpu) == \
        (0, 1, False, None)
    assert not td.is_initialized()

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("TULIP_TPU_MULTIHOST", "1")
    args = get_args_parser().parse_args(
        ["--device", "cpu", "--dist_url", f"file://{tmp_path / 'init'}"])
    TMesh.init_distributed_mode(args)
    try:
        assert args.distributed and args.gpu is None
        assert td.get_backend() == "gloo" and td.get_world_size() == 1
    finally:
        td.destroy_process_group()

    calls = []
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(TMesh.torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(TMesh.td, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    args = get_args_parser().parse_args(["--dist_url", "env://"])
    TMesh.init_distributed_mode(args)
    assert calls == [1, ("nccl", dict(init_method="env://", world_size=4,
                                      rank=3))]
    assert (args.rank, args.gpu, args.distributed) == (3, 1, True)


@pytest.mark.parametrize("env,dist_on_itp", [
    ({}, False),
    ({"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     False),
    ({"RANK": "1", "WORLD_SIZE": "2"}, False),
    ({"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "MASTER_ADDR": "h"}, False),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "MASTER_ADDR": "h"}, True)])
def test_discover_launcher_env_equals_the_original(monkeypatch, env,
                                                   dist_on_itp):
    from tulip_tpu.parallel.mesh import discover_launcher_env as ref
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = get_args_parser().parse_args(["--dist_on_itp"] if dist_on_itp
                                        else [])
    assert TMesh.discover_launcher_env(args) == ref(args)


SCRIPTS = sorted(glob.glob(os.path.join(REPO, "bash_scripts", "tulip_*.sh")))


@pytest.mark.parametrize("script", SCRIPTS, ids=[os.path.basename(s)
                                                 for s in SCRIPTS])
def test_parser_takes_every_flag_of_the_shipped_scripts(script):
    """Each bash_scripts/tulip_*.sh passes an args=( ... ) array to the
    entry point: the port's parser takes it whole and reads what the JAX
    package's reads."""
    text = open(script).read()
    body = text[text.index("args=(") + 6:text.index("\n    )")]
    argv = shlex.split(body, comments=True)
    assert argv and "main_lidar_upsampling.py" in text
    ours = vars(get_args_parser().parse_args(argv))
    assert ours == vars(JCfg.get_args_parser().parse_args(argv))
    assert ours["device"] == "cuda"
