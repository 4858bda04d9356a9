"""Launcher discovery, the process group and the replicas (port of
tulip_tpu/parallel/mesh.py, single-axis form).

One process drives one device, as in the reference (tulip/util/misc.py:
253-285): under ``torchrun --nproc_per_node=N`` (or OpenMPI / SLURM) the N
ranks join one ``torch.distributed`` group and train data-parallel.  The
JAX package's names map onto the group so:

- ``make_mesh``: a one-axis ``data`` mesh over N devices is the group
  itself, N ranks of one device each (``--mesh_shape`` may name it: N, the
  world size);
- ``replicate``: :func:`replicate` broadcasts the parameters from rank 0
  after start-up or a resume, so the replicas start bit-equal;
- ``shard_batch``: each rank loads its own stride of the epoch
  (``data.pipeline.ShardedSampler(num_replicas=world, rank=rank)``) and
  feeds ``--batch_size`` samples a step; the global batch is
  ``batch_size x N``;
- XLA's psum of the gradients inside the jitted step: the train step
  averages the ``.grad``s across the group after each backward
  (``dist.average_``).

The backend follows ``--device``: nccl for ``cuda``, gloo for ``cpu``.
``TULIP_TPU_MULTIHOST=1`` asks the JAX package for one process per host;
in torch a job over several hosts is the same one group of ranks, so the
variable asks for nothing more here.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as td

from ..utils.logger import setup_for_distributed
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


def _under_launcher() -> bool:
    """Whether a launcher gave this process a rank: torchrun's (or
    ``--dist_on_itp``'s re-exported) RANK and WORLD_SIZE, or SLURM's."""
    env = os.environ
    return ("RANK" in env and "WORLD_SIZE" in env) or "SLURM_PROCID" in env


def init_distributed_mode(args) -> None:
    """torchrun/OMPI/SLURM-compatible start-up (reference: misc.py:253-285).

    Sets ``args.rank``, ``args.world_size``, ``args.gpu`` and
    ``args.distributed``.  Under a launcher (world size 1 included, as in
    the reference) it joins the group at ``--dist_url`` (``env://`` under
    torchrun, or a ``file://`` path): nccl on ``cuda:LOCAL_RANK`` for
    ``--device cuda``, gloo for ``--device cpu``, and only rank 0 prints.
    Without one, nothing is initialised and the process runs alone."""
    rank, world, _ = discover_launcher_env(args)
    args.rank, args.world_size, args.gpu = rank, world, None
    args.distributed = _under_launcher()
    if args.distributed:
        cuda = torch.device(args.device).type == "cuda"
        if cuda:
            args.gpu = int(os.environ.get(
                "LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
            torch.cuda.set_device(args.gpu)
        print(f"| distributed init (rank {rank}): {args.dist_url}, "
              f"gpu {args.gpu}", flush=True)
        td.init_process_group("nccl" if cuda else "gloo",
                              init_method=args.dist_url, world_size=world,
                              rank=rank)
    setup_for_distributed(rank == 0)


def check_mesh_shape(mesh_shape) -> None:
    """``--mesh_shape``: the one-axis data mesh the group is, so N, the
    world size, or nothing."""
    world = dist.get_world_size()
    if mesh_shape and list(mesh_shape) != [world]:
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, mesh_shape))}: the port's mesh "
            f"is one data axis over the {world} rank(s) of the group; pass "
            f"--mesh_shape {world} or leave it out")


def replicate(model: torch.nn.Module) -> None:
    """Broadcast the parameters from rank 0 (the JAX package's replicated
    sharding): every replica starts from rank 0's bits."""
    with torch.no_grad():
        dist.broadcast_(list(model.parameters()))

