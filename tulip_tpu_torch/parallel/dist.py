"""Single-process stand-in for tulip_tpu/parallel/dist.py (data parallel
is a later slice, which replaces this module)."""

import torch.distributed as td


def get_world_size() -> int:
    return 1


def get_rank() -> int:
    """0: the command line keeps only the launcher's rank 0 alive
    (parallel/mesh.py:init_distributed_mode)."""
    return 0


def is_main_process() -> bool:
    return get_rank() == 0


def all_reduce_mean(x: float) -> float:
    """The identity in one process; refuses to run under torch.distributed,
    where it would silently skip the reduction."""
    if td.is_available() and td.is_initialized():
        raise NotImplementedError("data-parallel training is not ported: "
                                  "torch.distributed is initialised")
    return x
