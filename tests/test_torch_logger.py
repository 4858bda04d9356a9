"""The port's metric logger across processes (tulip_tpu_torch.utils.logger,
parallel/dist.py): synchronize_between_processes leaves one process's
meters as they are, train_one_epoch calls it once before "Averaged stats"
(as tulip_tpu/train/engine.py does), and under a two-process gloo group
(a FileStore under tmp_path, no TCP rendezvous) both ranks' meters end up
with the summed count and total."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

from tulip_tpu_torch.train import engine as TE
from tulip_tpu_torch.utils.logger import MetricLogger, SmoothedValue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = """
import json, sys
import torch.distributed as td
from tulip_tpu_torch.parallel import dist
from tulip_tpu_torch.utils.logger import MetricLogger
rank, path = int(sys.argv[1]), sys.argv[2]
td.init_process_group("gloo", store=td.FileStore(path, 2), rank=rank,
                      world_size=2)
log = MetricLogger()
for v in ([1.0, 2.0, 3.0] if rank == 0 else [10.0]):
    log.update(loss=v)
log.synchronize_between_processes()
m = log.meters["loss"]
print(json.dumps(dict(world=dist.get_world_size(), count=m.count,
                      total=m.total, avg=m.global_avg, median=m.median)))
td.destroy_process_group()
"""


def _args():
    return types.SimpleNamespace(accum_iter=1, lr=5e-4, min_lr=0.0,
                                 warmup_epochs=1, epochs=2, seed=0,
                                 log_transform=True, pin_mem=False)


def test_synchronize_is_the_identity_in_one_process(monkeypatch):
    log = MetricLogger()
    log.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    for v in (0.5, 1.5, 4.0):
        log.update(loss=v, lr=v / 10)
    before = {k: (m.count, m.total, list(m.deque))
              for k, m in log.meters.items()}
    log.synchronize_between_processes()
    assert {k: (m.count, m.total, list(m.deque))
            for k, m in log.meters.items()} == before

    calls = []
    orig = MetricLogger.synchronize_between_processes

    def counting(self):
        calls.append(dict(self.meters))
        orig(self)

    monkeypatch.setattr(MetricLogger, "synchronize_between_processes",
                        counting)
    batch = ({"sample": np.zeros((1, 1, 16, 256), np.float32)},
             {"sample": np.zeros((1, 1, 64, 256), np.float32)})
    step = lambda *a: (torch.tensor(0.5), torch.tensor(0.25))
    stats = TE.train_one_epoch(step, [batch] * 3, 0, device="cpu",
                               args=_args())
    assert len(calls) == 1 and set(calls[0]) == {"lr", "loss"}
    assert stats["loss"] == 0.5


def test_two_ranks_sum_their_meters(tmp_path):
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), store],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for o, median in zip(outs, (2.0, 10.0)):
        # count and total summed over both ranks, the window kept local
        assert o == dict(world=2, count=4, total=16.0, avg=4.0,
                         median=median)
