"""The port's utils/flops.py against the JAX package's (the same integers
for every config; the MFU arithmetic; the card's peak) and its
utils/profiler.py on the CPU (traces, the step window, memory figures)."""

import glob
import json
import os

import pytest
import torch

from tulip_tpu.config import model_config as jax_model_config
from tulip_tpu.utils import flops as JF
from tulip_tpu_torch.config import model_config
from tulip_tpu_torch.utils import flops as TF
from tulip_tpu_torch.utils import logger as TL
from tulip_tpu_torch.utils import profiler as TP

# the geometries of bash_scripts/tulip_upsampling_{durlar,kitti}.sh (that
# of tulip_upsampling_carla.sh is DurLAR's) and CARLA's 16 x 256 folders
GEOMETRIES = {"durlar": ((32, 2048), (128, 2048)),
              "kitti": ((16, 1024), (64, 1024)),
              "carla": ((16, 256), (64, 256))}


@pytest.mark.parametrize("circular_padding", [True, False],
                         ids=["circular", "plain_pad"])
@pytest.mark.parametrize("pixel_shuffle", [True, False],
                         ids=["shuffle", "expand"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", ["tulip_base", "tulip_large"])
def test_flops_equal_jax(name, geometry, pixel_shuffle, circular_padding):
    low, high = GEOMETRIES[geometry]
    kw = dict(img_size=low, target_img_size=high, patch_size=(1, 4),
              window_size=(2, 8), pixel_shuffle=pixel_shuffle,
              circular_padding=circular_padding, log_transform=True,
              patch_unmerging=True)
    ours, ref = model_config(name, **kw), jax_model_config(name, **kw)
    fwd = TF.model_forward_flops(ours)
    assert type(fwd) is int and fwd == JF.model_forward_flops(ref) > 0
    assert TF.model_train_flops(ours) == JF.model_train_flops(ref) == 3 * fwd


def test_flagship_forward_flops():
    cfg = model_config("tulip_base", img_size=(32, 2048),
                       target_img_size=(128, 2048), pixel_shuffle=True,
                       circular_padding=True, patch_unmerging=True)
    assert round(TF.model_forward_flops(cfg) / 1e9, 2) == 61.81


@pytest.mark.parametrize("ips,fpi,peak", [(100.0, 50e9, 100.0),
                                          (1100.0, 61_810_000_000, 989.0),
                                          (3.5, 123_456_789, 0.5)])
def test_mfu_arithmetic(ips, fpi, peak):
    assert TF.mfu(ips, fpi, peak_tflops=peak) == JF.mfu(ips, fpi,
                                                        peak_tflops=peak)
    tflops, share = TF.mfu(ips, fpi, peak_tflops=peak)
    assert tflops == ips * fpi / 1e12 and share == tflops / peak


def test_chip_peak_tflops():
    assert TF.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert TF.chip_peak_tflops("nvidia h100 80gb hbm3") == 989.0
    for kind in ("TPU v5 lite", "unknown-device", ""):
        with pytest.raises(ValueError, match="no dense-bf16 peak"):
            TF.chip_peak_tflops(kind)


def _trace_events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_tensorboard_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    a = torch.ones(8, 8)
    with TP.trace(log_dir):
        (a @ a).sum()
    names = _trace_events(log_dir)
    assert "aten::mm" in names or "aten::matmul" in names, sorted(names)[:20]


def test_step_window_profiler(tmp_path):
    log_dir = str(tmp_path / "window")
    prof = TP.StepWindowProfiler(log_dir, start=2, stop=4)
    active = []
    a = torch.ones(4, 4)
    for step in range(6):
        prof.on_step(step)
        active.append(prof.active)
        torch.add(a, step)
    prof.close()
    assert active == [False, False, True, True, False, False]
    assert "aten::add" in _trace_events(log_dir)
    # a window still open when the loop ends is closed, and its trace written
    late = TP.StepWindowProfiler(str(tmp_path / "late"), start=1, stop=9)
    for step in range(3):
        late.on_step(step)
    assert late.active
    late.close()
    late.close()
    assert not late.active
    assert len(glob.glob(str(tmp_path / "late" / "*.pt.trace.json"))) == 1


def test_device_memory_stats_on_the_cpu(capsys):
    assert TP.device_memory_stats(torch.device("cpu")) == {}
    assert TP.device_memory_stats("cpu") == {}
    if not torch.cuda.is_initialized():
        assert TP.device_memory_stats() == {}
        # so the metric logger prints no "max mem" here
        logger = TL.MetricLogger(delimiter="  ")
        for _ in logger.log_every(range(2), 1, "h"):
            logger.update(loss=1.0)
        assert "max mem" not in capsys.readouterr().out
