"""Launcher discovery, the process group, the dp x sp layout and the
replicas (port of tulip_tpu/parallel/mesh.py).

One process drives one device, as in the reference (tulip/util/misc.py:
253-285): under ``torchrun --nproc_per_node=N`` (or OpenMPI / SLURM) the N
ranks join one ``torch.distributed`` group and train data-parallel.  The
JAX package's names map onto the group so:

- ``make_mesh``: a one-axis ``data`` mesh over N devices is the group
  itself, N ranks of one device each (``--mesh_shape`` may name it: N, the
  world size); ``make_mesh((N // sp, sp), ("data", "seq"))`` of W-axis
  sequence parallel is :func:`make_mesh` ``(sp)``, a :class:`Mesh` over
  the same ranks in JAX's device order, seq fastest: rank = d·sp + s
  (``--mesh_shape`` may name it: N // sp, sp);
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
from typing import Any, NamedTuple

import torch
import torch.distributed as td

from ..utils.logger import setup_for_distributed
from . import dist
from .halo import SeqRing


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


class Mesh(NamedTuple):
    """The (data, seq) layout of the group's ranks: ``dp`` data indices of
    ``sp`` W shards each, rank = d·sp + s; ``group`` is the process group
    of this rank's seq ring (None: the whole world, where dp is 1)."""
    dp: int
    sp: int
    rank: int
    group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.sp

    @property
    def seq_index(self) -> int:
        return self.rank % self.sp

    def ring(self) -> SeqRing:
        """This rank's W ring: its seq index and its left / right
        neighbours' global ranks, cyclic within its data index."""
        base, s = self.data_index * self.sp, self.seq_index
        return SeqRing(self.sp, s, base + (s - 1) % self.sp,
                       base + (s + 1) % self.sp, self.group)


def make_mesh(sp: int = 1) -> Mesh:
    """The world as (world // sp) data x sp seq ranks.  Raises ValueError
    where sp does not divide the world.  Where there are several seq rings
    every rank makes every ring's group (torch.distributed.new_group is
    collective) and keeps its own."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if sp < 1 or world % sp:
        raise ValueError(f"--sp_degree {sp} does not divide the world of "
                         f"{world} rank(s)")
    dp, group = world // sp, None
    if dp > 1 and sp > 1:
        for d in range(dp):
            g = td.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == rank // sp:
                group = g
    return Mesh(dp, sp, rank, group)


def check_mesh_shape(mesh_shape, sp: int = 1) -> None:
    """``--mesh_shape``: the group's one data axis, N, the world size, or
    its (data, seq) layout, N // sp and sp (``--sp_degree``), or
    nothing."""
    world = dist.get_world_size()
    if mesh_shape and list(mesh_shape) not in ([world], [world // sp, sp]):
        raise ValueError(
            f"--mesh_shape {' '.join(map(str, mesh_shape))}: the port's mesh "
            f"is the {world} rank(s) of the group as {world // sp} data x "
            f"{sp} seq; pass --mesh_shape {world}, --mesh_shape "
            f"{world // sp} {sp} or leave it out")


def replicate(model: torch.nn.Module) -> None:
    """Broadcast the parameters from rank 0 (the JAX package's replicated
    sharding): every replica starts from rank 0's bits."""
    with torch.no_grad():
        dist.broadcast_(list(model.parameters()))

