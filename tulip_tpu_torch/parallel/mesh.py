"""Launcher discovery and start-up of the command line (port of
tulip_tpu/parallel/mesh.py:26-98, single-process form).

One process drives one GPU.  The shipped bash_scripts launch through
``torchrun --nproc_per_node=N``: as in the JAX package, rank 0 carries on
alone with ``batch_size x N`` as its global batch and the other ranks exit
cleanly, so the scripts run unchanged.  Real data parallel
(``torch.distributed``, a mesh, sharded batches) is not ported yet.
"""

from __future__ import annotations

import os

from . import dist


def discover_launcher_env(args=None):
    """Rank/world/coordinator discovery, same precedence as the reference's
    ``init_distributed_mode`` (tulip/util/misc.py:253-274):

    1. ``--dist_on_itp``: OpenMPI env (OMPI_COMM_WORLD_RANK/SIZE +
       MASTER_ADDR/MASTER_PORT); re-exports RANK/WORLD_SIZE/LOCAL_RANK like
       the reference does.
    2. torchrun env: RANK/WORLD_SIZE (+ MASTER_ADDR/MASTER_PORT).
    3. SLURM: SLURM_PROCID/SLURM_NTASKS.

    Returns (rank, world, coordinator_or_None).
    """
    env = os.environ
    if args is not None and getattr(args, "dist_on_itp", False) \
            and "OMPI_COMM_WORLD_RANK" in env:
        rank = int(env["OMPI_COMM_WORLD_RANK"])
        world = int(env["OMPI_COMM_WORLD_SIZE"])
        env["RANK"] = str(rank)
        env["WORLD_SIZE"] = str(world)
        env["LOCAL_RANK"] = env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")
        coord = None
        if "MASTER_ADDR" in env:
            coord = env["MASTER_ADDR"] + ":" + env.get("MASTER_PORT", "29500")
        return rank, world, coord
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        coord = None
        if "MASTER_ADDR" in env:
            coord = env["MASTER_ADDR"] + ":" + env.get("MASTER_PORT", "29500")
        return rank, world, coord
    if "SLURM_PROCID" in env:
        rank = int(env["SLURM_PROCID"])
        world = int(env.get("SLURM_NTASKS", "1"))
        coord = None
        if "MASTER_ADDR" in env:
            coord = env["MASTER_ADDR"] + ":" + env.get("MASTER_PORT", "29500")
        return rank, world, coord
    return 0, 1, None


def init_distributed_mode(args) -> None:
    """torchrun/OMPI/SLURM-compatible startup (reference: misc.py:253-285).

    Sets ``args.rank``, ``args.launcher_world_size`` and
    ``args.distributed = False``.  Under a launcher with more than one
    process, every rank but 0 prints and exits with code 0; rank 0 drives
    the one device.  ``TULIP_TPU_MULTIHOST=1`` asks for one process per
    host joined into one job, which needs the data-parallel slice
    (slice 5 of the port) and raises."""
    rank, world, _ = discover_launcher_env(args)
    args.rank = rank
    args.launcher_world_size = world
    args.distributed = False
    if int(os.environ.get("TULIP_TPU_MULTIHOST", "0")):
        raise NotImplementedError(
            "TULIP_TPU_MULTIHOST=1: multi-process data parallel is slice 5 "
            "of the port (parallel/{mesh,dist}.py over torch.distributed) "
            "and is not ported yet")
    if world > 1 and rank > 0:
        print(f"[tulip_tpu_torch] torchrun rank {rank}/{world}: one process "
              "drives the device from rank 0; this rank exits.")
        raise SystemExit(0)
    from ..utils.logger import setup_for_distributed
    setup_for_distributed(dist.is_main_process())
