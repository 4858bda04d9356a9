"""Rank, world size and the reductions of data-parallel training (port of
tulip_tpu/parallel/dist.py, reference: tulip/util/misc.py:189-215, 44-55,
473-481).

One process drives one device, as in the reference; the ranks form one
``torch.distributed`` group (parallel/mesh.py:init_distributed_mode).
Without an initialised group everything here is the identity and the rank
is 0.  Under one, every function reduces over that group, on the devices
its tensors live on: nothing here picks a backend (the command line takes
nccl for ``--device cuda`` and gloo for ``--device cpu``).

Where the JAX package sums gradients with XLA's psum inside the jitted
step, the port averages them with :func:`average_` after each backward
(train/step.py), in a few flat buckets rather than one call a tensor.
"""

from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch
import torch.distributed as td

# the most bytes of one flat bucket of average_ / broadcast_: TULIP-base's
# 108.6 MB of fp32 gradients go in four collectives
BUCKET_BYTES = 32 << 20


def in_group() -> bool:
    """Whether a torch.distributed group is initialised (of 1 rank, too)."""
    return td.is_available() and td.is_initialized()


def get_world_size() -> int:
    """The ranks of an initialised torch.distributed group, else 1."""
    return td.get_world_size() if in_group() else 1


def get_rank() -> int:
    """This process's rank in the group, else 0."""
    return td.get_rank() if in_group() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def get_num_devices() -> int:
    """The devices of the job: one a rank."""
    return get_world_size()


def barrier() -> None:
    if get_world_size() > 1:
        td.barrier()


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
    """The mean of a host scalar over the ranks (reference: misc.py:473-481)."""
    world_size = get_world_size()
    if world_size > 1:
        return float(all_reduce_sum(np.asarray([x], np.float64))[0]) / world_size
    return x


def _buckets(tensors: Sequence[torch.Tensor],
             cap: int) -> Iterator[List[torch.Tensor]]:
    """Runs of consecutive tensors of one dtype and device, each of at most
    ``cap`` bytes (or one tensor, where a tensor is larger)."""
    run, size = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if run and (size + n > cap or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, size = [], 0
        run.append(t)
        size += n
    if run:
        yield run


def _through_buckets(tensors: Sequence[torch.Tensor],
                     collective: Callable[[torch.Tensor], None]) -> None:
    """Copy each bucket into one flat tensor, run ``collective`` on it in
    place and copy the pieces back, each way in one multi-tensor copy (212
    separate copies of TULIP-base's gradients took 0.33 ms of device time
    on an H100, a cat 0.23)."""
    for run in _buckets(tensors, BUCKET_BYTES):
        flat = torch.empty(sum(t.numel() for t in run), dtype=run[0].dtype,
                           device=run[0].device)
        pieces = [piece.view(t.shape) for t, piece in
                  zip(run, flat.split([t.numel() for t in run]))]
        torch._foreach_copy_(pieces, run)
        collective(flat)
        torch._foreach_copy_(run, pieces)


def average_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` in place across the group: SUM, then / world
    (gloo has no ReduceOp.AVG).  Every rank ends with the same bits; in a
    group of one rank they are the bits it had.  The identity without a
    group."""
    if not in_group():
        return
    world = get_world_size()

    def mean(flat):
        td.all_reduce(flat, op=td.ReduceOp.SUM)
        if world > 1:
            flat.div_(world)

    _through_buckets(tensors, mean)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place on every rank with rank ``src``'s."""
    if not in_group():
        return
    _through_buckets(tensors, lambda flat: td.broadcast(flat, src))
