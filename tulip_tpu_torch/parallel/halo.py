"""Grid rolls, circular padding and the halo exchanges of W-axis sequence
parallel (port of tulip_tpu/parallel/halo.py).

The token grid is a cylindrical range image: every op of the model that
crosses a W shard is cyclic along W, the patch embed's circular pad
(reference: tulip/model/tulip.py:59-61) and the shifted-window rolls
(tulip.py:289-291).  Under a W-sharded layout both become an exchange of a
few boundary columns with the two neighbours of the shard's ring.

The functions are context-switched, as in the JAX package: outside
:func:`sequence_axis` they are the single-device ops, bit for bit; inside
it (``parallel/sp.py`` enters it around a sharded forward) the grid is
this rank's W shard and the columns that cross its edges come from the
ring.

One exchange is one ``torch.distributed.batch_isend_irecv`` of this
rank's sends to its neighbours and its receives from them, on the
backend of the ring's group: no rank waits for a send that another rank
has not posted.  It is a ``torch.autograd.Function`` whose backward is
the mirrored exchange: the cotangent of a received column goes back to
the rank that owns it.  Under nccl the columns go device to device;
gloo has no CUDA point-to-point, so under gloo the columns of a CUDA
tensor are staged through host memory.  The branch follows the group's
backend, never a failure, and :data:`TRANSPORT` counts which one ran.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as td


class SeqRing(NamedTuple):
    """The W shards of one data index: ``size`` ranks in seq order, this
    rank at ``index``, its neighbours ``left`` / ``right`` (global ranks),
    and the process group whose backend carries the exchanges."""
    size: int
    index: int
    left: int
    right: int
    group: Any = None


_RING: Optional[SeqRing] = None
# the shifted blocks' local masks under the ring (module -> (nW, L, L))
_MASKS: Dict[Any, torch.Tensor] = {}

# exchanges by transport: "nccl" (device to device), "gloo" (host tensors),
# "gloo, host-staged" (CUDA tensors through host memory)
TRANSPORT: Dict[str, int] = {}


def exchanges() -> int:
    """Exchange rounds so far, forward and backward, all transports."""
    return sum(TRANSPORT.values())


@contextmanager
def sequence_axis(ring: SeqRing, masks: Optional[Dict[Any, torch.Tensor]]
                  = None):
    """W-sharded semantics for :func:`roll_hw`, :func:`roll_w` and
    :func:`circular_pad_w` over ``ring``; ``masks`` gives the shifted
    blocks their local masks (:func:`block_mask`)."""
    global _RING, _MASKS
    prev = _RING, _MASKS
    _RING, _MASKS = ring, dict(masks or {})
    try:
        yield
    finally:
        _RING, _MASKS = prev


def current_sequence_axis() -> Optional[SeqRing]:
    return _RING


def block_mask(block, default):
    """The attention mask of ``block``: its local mask under a ring that
    names one, else ``default`` (the block's own, for the whole grid)."""
    return _MASKS.get(block, default) if _RING is not None else default


def _transport(ring: SeqRing, t: torch.Tensor) -> str:
    backend = td.get_backend(ring.group)
    if backend == "gloo" and t.is_cuda:
        return "gloo, host-staged"
    return backend


def _exchange(ring: SeqRing, to_right: Optional[torch.Tensor],
              to_left: Optional[torch.Tensor]):
    """Send ``to_right`` to the right neighbour and ``to_left`` to the left
    one (either may be None) and receive theirs: (from_left, from_right),
    the left neighbour's ``to_right`` and the right neighbour's
    ``to_left``; all shards send blocks of one shape.  Sends and receives
    are posted in one order on every rank (right-going first), so that
    two messages between the same pair (a ring of 2) match."""
    any_t = to_right if to_right is not None else to_left
    how = _transport(ring, any_t)
    staged = how == "gloo, host-staged"
    ops, outs, back = [], [None, None], []
    for i, (t, dst, src) in enumerate(((to_right, ring.right, ring.left),
                                       (to_left, ring.left, ring.right))):
        if t is None:
            continue
        t = t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if staged else t.device)
        ops.append(td.P2POp(td.isend, t.cpu() if staged else t, dst,
                            ring.group, tag=i))
        ops.append(td.P2POp(td.irecv, buf, src, ring.group, tag=i))
        outs[i] = buf
        back.append((i, t.device))
    for work in td.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for i, device in back:
            outs[i] = outs[i].to(device)
    TRANSPORT[how] = TRANSPORT.get(how, 0) + 1
    return outs[0], outs[1]


class _Halo(torch.autograd.Function):
    """(to_right, to_left) -> (from_left, from_right) over the ring; the
    backward sends each received block's cotangent back to its owner."""

    @staticmethod
    def forward(ctx, ring, to_right, to_left):
        ctx.ring = ring
        ctx.sent = (to_right is not None, to_left is not None)
        return _exchange(ring, to_right, to_left)

    @staticmethod
    def backward(ctx, g_from_left, g_from_right):
        sent_right, sent_left = ctx.sent
        # from_left's cotangent goes back left and from_right's right; what
        # comes in is the cotangent of this rank's own sends: the left
        # neighbour's of our to_left, the right neighbour's of our to_right
        g_to_left, g_to_right = _exchange(
            ctx.ring, g_from_right if sent_left else None,
            g_from_left if sent_right else None)
        return None, g_to_right, g_to_left


def _halo(to_right: Optional[torch.Tensor], to_left: Optional[torch.Tensor]):
    """One differentiable exchange over the active ring (see _exchange)."""
    return _Halo.apply(_RING, to_right, to_left)


def sharded() -> bool:
    """Whether a ring of more than one shard is active."""
    return _RING is not None and _RING.size > 1


def roll_w(x: torch.Tensor, shift: int, dim: int = 2) -> torch.Tensor:
    """A cyclic roll of the whole W axis by ``shift`` (``dim`` of x): under
    a ring, this shard's columns that leave it go to a neighbour and the
    neighbour's come in.  |shift| must be below the shard's width (half a
    window, 4 columns, in the model)."""
    if shift == 0:
        return x
    if not sharded():
        return torch.roll(x, shift, dims=dim)
    n = x.shape[dim]
    s = abs(shift)
    if s >= n:
        raise ValueError(f"roll by {shift} of a W shard {n} wide")
    if shift < 0:      # the first s columns go to the left neighbour
        _, edge = _halo(None, x.narrow(dim, 0, s))
        return torch.cat([x.narrow(dim, s, n - s), edge], dim=dim)
    edge, _ = _halo(x.narrow(dim, n - s, s), None)
    return torch.cat([edge, x.narrow(dim, 0, n - s)], dim=dim)


def roll_hw(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Roll a (B, H, W, C) grid by (sh, sw).  H is whole on every rank;
    under a ring W is cyclic across the shards."""
    if not sharded():
        if sh or sw:
            return torch.roll(x, shifts=(sh, sw), dims=(1, 2))
        return x
    if sh:
        x = torch.roll(x, sh, dims=1)
    return roll_w(x, sw)


def circular_pad_w(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Cyclically pad the W axis of (B, H, W, C) by (left, right) columns
    (the patch-embed circular padding); under a ring the pad columns are
    the neighbours' edge columns, both in one exchange."""
    W = x.shape[2]
    if not sharded():
        return torch.cat([x[:, :, W - left:], x, x[:, :, :right]], dim=2)
    from_left, from_right = _halo(x[:, :, W - left:], x[:, :, :right])
    return torch.cat([from_left, x, from_right], dim=2)
