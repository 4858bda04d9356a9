"""W-axis sequence parallel: the token grid sharded along W over the seq
ranks of a dp x sp layout (port of tulip_tpu/parallel/sp.py).

The cylindrical range image is cut into ``sp`` equal W shards, one a rank
of a data index's seq ring (``parallel/mesh.py:Mesh``, rank = d·sp + s).
Every rank runs the same Swin U-Net on its shard; the shards meet only in
halo exchanges of a few boundary columns (``parallel/halo.py``): the
patch embed's circular pad (2 columns a side) and the shifted windows'
W roll (half a window, 4 columns at window 2 x 8), twice a shifted block.
The kernels see the local shard: the shifted blocks hand them the W-rolled
shard with shift (sh, 0), so the H roll stays addressing inside them, and
the local mask; Swin-v2's shifted blocks roll the shard (``halo.roll_hw``)
and partition its windows with the local mask.  Everything else is
token-local or a local 2 x 2 space-to-depth: the merges (v1 and v2), the
unmerging or PatchExpanding, the skip concats and either head run
unchanged on the shard.

Masks.  The reference's shifted-window mask marks the boundary regions
of the *globally last* window column along W only (tulip/model/
tulip.py:254-280).  Each shifted block therefore has two local variants
(:func:`_sp_block`): "last", the mask of the local grid, whose last
window column is the W boundary, for the globally last shard; and "body",
every window column W-interior (column 0 of the local mask, repeated),
for the others.  JAX selects by ``lax.axis_index`` inside one traced
program; here each rank is its own eager program, so the variant is fixed
when the forward is made.

Why the world mean of the gradients is right.  The shards are equal, so
the L1 mean over the whole scan is the mean of the ranks' local means;
each rank backpropagates its own local mean.  The exchange's backward
sends each halo column's cotangent to the rank that owns the column, so
rank r's parameters also receive the part of its neighbours' losses that
flowed through its columns: summed over the ranks that is the gradient of
the sum of the local means.  The world mean of the ranks' gradients (data
parallel's ``dist.average_``, over the dp x sp ranks) is then the gradient of
the global loss: the mean over the data indices of their scans' means.
No subgroup is needed for it.  A run that skipped the backward exchange
would lose the neighbours' terms and fail the tests against one process.

Draws.  A run on dp x sp ranks draws what one process draws on the whole
batch and the whole scan.  Drop-path drops the same samples in every W
shard: the seq ranks of a data index keep the same rows of the global draw
(``layers.RankDraws(generator, data_index, dp)``), as the JAX package folds
only the data index into its key.  Dropout, in modes 'train' and 'mc' at a
non-zero ``drop_rate`` / ``attn_drop_rate``, draws the keep mask of the
whole global tensor at every site and keeps the rank's rows and its shard's
W columns (``RankDraws`` with the ring's ``seq`` / ``n_seq``; each site
names where W lies in its tensor, tokens or windows): the mask of one
process, at up to sp times the local draw's cost.  The JAX package draws
a local mask on every shard instead (one key across the shards in 'train',
the seq index folded in in 'mc'), which is not the unsharded model's draw.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as td

from ..models.layers import RankDraws
from ..models.swin import BlockStatic, make_block_static
from ..models.tulip import TULIP, apply_model
from ..train.step import make_train_step
from . import halo
from .mesh import Mesh


class SpBlock(NamedTuple):
    st: BlockStatic                     # local-grid statics, "last" mask
    mask_body: Optional[np.ndarray]     # the body mask, or None (unshifted)


class SpStatics(NamedTuple):
    enc: Tuple[Tuple[SpBlock, ...], ...]
    dec: Tuple[Tuple[SpBlock, ...], ...]
    n_seq: int


def _sp_block(stage_local, j, config_window) -> SpBlock:
    st = make_block_static(stage_local, j, config_window)
    if st.mask is None:
        return SpBlock(st, None)
    # the local mask's window columns 0..nW-2 are alike (only the last ww
    # columns hold W-boundary regions), so column 0 repeated over W is the
    # body mask
    wh, ww = stage_local.window
    nH = stage_local.grid[0] // wh
    nW = stage_local.grid[1] // ww
    if nW < 2:
        raise ValueError(
            f"sequence-parallel shard too narrow: {stage_local.grid} with "
            f"window {stage_local.window} leaves {nW} window column(s); "
            "need >= 2")
    Lw = st.mask.shape[-1]
    m = st.mask.reshape(nH, nW, Lw, Lw)
    mask_body = np.ascontiguousarray(
        np.broadcast_to(m[:, :1], m.shape)).reshape(nH * nW, Lw, Lw)
    return SpBlock(st, mask_body)


def build_sp_statics(model: TULIP, n_seq: int) -> SpStatics:
    """The blocks' statics on the local grid of an ``n_seq``-way W
    sharding."""
    cfg = model.cfg

    def shard_stage(stage):
        H, W = stage.grid
        if W % n_seq:
            raise ValueError(f"token grid W={W} not divisible by sp={n_seq}")
        local = dataclasses.replace(stage, grid=(H, W // n_seq))
        cw = local.window if cfg.swin_v2 else cfg.window_size
        return tuple(_sp_block(local, j, cw) for j in range(local.depth))

    return SpStatics(
        enc=tuple(shard_stage(s) for s in cfg.encoder_stages),
        dec=tuple(shard_stage(s) for s in cfg.decoder_stages),
        n_seq=n_seq)


def max_sp_degree(model: TULIP) -> int:
    """The largest ``--sp_degree`` of this geometry: every stage's shard
    keeps >= 2 window columns (the body / last scheme and the one-ring
    exchange want a W-interior window column a shard), and the token grid's
    W divides evenly.  The least cap over the stages; the JAX package's
    loop lets a later stage's cap replace a cap of 1 (so it gives 2 for
    TULIP-base at 16 x 256, whose third stage holds one window column
    over 2 shards); both give 4 for the flagship."""
    cfg = model.cfg
    caps = []
    for stage in tuple(cfg.encoder_stages) + tuple(cfg.decoder_stages):
        H, W = stage.grid
        ww = stage.window[1]
        cap = max(1, W // (2 * ww))
        while cap > 1 and W % cap:
            cap -= 1
        caps.append(cap)
    return min(caps)


def _local_masks(model: TULIP, statics: SpStatics, last: bool):
    """(block module, its local mask as numpy) for every shifted block."""
    pairs = []
    for stages, sts in ((model.layers, statics.enc),
                        (model.layers_up, statics.dec)):
        for stage, st_blocks in zip(stages, sts):
            for blk, sb in zip(stage.blocks, st_blocks):
                if sb.mask_body is not None:
                    pairs.append((blk, sb.st.mask if last else sb.mask_body))
    return pairs


def make_sp_forward(model: TULIP, mesh: Mesh, *, mode: str = "train",
                    compute_dtype=torch.bfloat16):
    """Build the W-sharded forward of this rank:
    ``run(x, target=None, generator=None)`` with x (and target) this rank's
    W shard in NCHW, as :func:`~tulip_tpu_torch.models.tulip.apply_model`:
    pred alone without a target, else (pred, total_loss, pixel_loss) of the
    shard.  ``mode`` as there: 'train' (autograd on, drop-path and
    dropout), 'mc' (dropout), 'eval'.  ``generator`` draws them: a
    ``torch.Generator`` where this ring holds the whole batch, a
    ``layers.RankDraws`` of the data index where it holds a data index's
    rows; the forward adds the ring's seq index to it, so that every shard
    keeps its columns of the whole scan's masks.  Every rank of the ring
    calls it in step: the exchanges are collective."""
    statics = build_sp_statics(model, mesh.sp)
    ring = mesh.ring()
    pairs = _local_masks(model, statics, ring.index == ring.size - 1)
    by_device = {}

    def run(x, target=None, generator=None):
        if x.device not in by_device:
            by_device[x.device] = {blk: torch.as_tensor(m, device=x.device)
                                   for blk, m in pairs}
        with halo.sequence_axis(ring, by_device[x.device]):
            return apply_model(model, x, target, mode=mode,
                               mc_drop=target is None,
                               compute_dtype=compute_dtype,
                               generator=seq_draws(generator, ring))

    run.mesh = mesh
    return run


def seq_draws(generator, ring: halo.SeqRing):
    """``generator`` (None, a ``torch.Generator`` of the whole batch or a
    ``layers.RankDraws`` of a data index) as the draws of this rank's W
    shard: seq shard ``ring.index`` of ``ring.size``."""
    if generator is None:
        return None
    if not isinstance(generator, RankDraws):
        generator = RankDraws(generator, 0, 1)
    return generator._replace(seq=ring.index, n_seq=ring.size)


def shard_w(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's W shard of a whole NCHW (or any ..., W) tensor."""
    w = x.shape[-1] // mesh.sp
    return x[..., mesh.seq_index * w:(mesh.seq_index + 1) * w].contiguous()


def gather_w(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ring's W shards joined in seq order, on every rank of the ring
    (an all_gather; under gloo a CUDA tensor goes through host memory)."""
    group = mesh.group
    staged = td.get_backend(group) == "gloo" and x.is_cuda
    t = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.sp)]
    td.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=-1)
    return out.to(x.device) if staged else out


def make_sp_eval_forward(model: TULIP, mesh: Mesh, *, mode: str = "eval",
                         compute_dtype=torch.float32):
    """``fwd(low, generator=None) -> pred`` on whole NCHW scans, for
    ``evaluate`` / ``MCdrop``'s ``sp_forward``: every rank of the ring runs
    its shard, and the shards are gathered in seq order.  In mode 'mc' the
    dropout comes from ``generator``, which every rank of the ring seeds
    alike (MCdrop's chunk generator): each shard keeps its columns of the
    masks one process draws on the whole scans."""
    run = make_sp_forward(model, mesh, mode=mode, compute_dtype=compute_dtype)

    def fwd(low, generator=None):
        return gather_w(run(shard_w(low, mesh), generator=generator), mesh)

    fwd.mesh = mesh
    return fwd


def make_sp_train_step(model: TULIP, opt: torch.optim.Optimizer, mesh: Mesh,
                       *, accum_iter: int = 1, compute_dtype=torch.bfloat16):
    """The dp x sp train step: ``step(low, high, lr, generator)`` with low /
    high this rank's W shard of its data index's batch, as
    ``train.step.make_train_step`` (its accumulation, its ``state_dict``,
    losses averaged over the world, which here is the global loss);
    ``step.mesh`` is the layout the train loop draws drop-path and dropout
    by (``RankDraws(generator, data_index, dp)``; the forward adds the seq
    shard)."""
    fwd = make_sp_forward(model, mesh, mode="train",
                          compute_dtype=compute_dtype)
    step = make_train_step(model, opt, accum_iter=accum_iter,
                           compute_dtype=compute_dtype, forward=fwd)
    step.mesh = mesh
    return step
