"""Rank and world size, and the small host reductions of the metric logger
(port of tulip_tpu/parallel/dist.py, reference: tulip/util/misc.py:189-215,
44-55, 473-481).

The command line runs one process (data parallel is a later slice, which
extends this module), so everything here is the identity there.  Under an
initialised ``torch.distributed`` group the world size is the group's and
:func:`all_reduce_sum` sums across it (gloo on the CPU, nccl on the current
CUDA device).
"""

import numpy as np
import torch
import torch.distributed as td


def _group() -> bool:
    return td.is_available() and td.is_initialized()


def get_world_size() -> int:
    """The ranks of an initialised torch.distributed group, else 1."""
    return td.get_world_size() if _group() else 1


def get_rank() -> int:
    """0: the command line keeps only the launcher's rank 0 alive
    (parallel/mesh.py:init_distributed_mode)."""
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def all_reduce_sum(x: np.ndarray) -> np.ndarray:
    """SUM all-reduce of a small host array (float64) across the ranks of
    the group; the array itself in one process."""
    if get_world_size() <= 1:
        return x
    device = (torch.device("cuda", torch.cuda.current_device())
              if td.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(np.asarray(x, np.float64), device=device)
    td.all_reduce(t, op=td.ReduceOp.SUM)
    return t.cpu().numpy()


def all_reduce_mean(x: float) -> float:
    """The identity in one process; refuses to run under torch.distributed,
    where it would silently skip the reduction."""
    if _group():
        raise NotImplementedError("data-parallel training is not ported: "
                                  "torch.distributed is initialised")
    return x
