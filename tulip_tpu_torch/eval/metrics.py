"""Evaluation metrics on the device: the bidirectional chamfer distance and
unique-voxel occupancy counts (port of tulip_tpu/eval/metrics.py).

The chamfer distance is mean_i min_j |p1_i - p2_j|^2 + mean_j min_i
|p1_i - p2_j|^2 (squared distances, as the reference's CUDA extension), swept
by the impl that ``ops.chamfer.get_chamfer_impl`` names.  The numpy helpers
(``voxel_metrics_sparse``, ``calculate_metrics``, ``_PAD_VALUE`` ...) are
re-exported from ``tulip_tpu.eval.metrics``, which imports jax only inside
its device functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tulip_tpu.eval.metrics import (  # noqa: F401
    _PAD_VALUE, calculate_metrics, depth_wise_unconcate, inverse_huber_loss,
    mean_absolute_error, voxel_metrics_sparse, voxelize_point_cloud,
)

from ..ops.chamfer import get_chamfer_impl


def _as_points(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _pad(x, n):
    """x (m, 3) followed by n - m sentinel rows."""
    fill = torch.full((n - x.shape[0], 3), _PAD_VALUE, device=x.device)
    return torch.cat([x, fill])


def _chunk_for(impl, size: int) -> int:
    pref = getattr(impl, "preferred_chunk", 4096)
    return pref if size >= pref else 512


def chamfer_distance(points1, points2, num_points: Optional[int] = None,
                     device=None) -> float:
    """Bidirectional squared-NN chamfer, mean(d1) + mean(d2) (reference:
    evaluation.py:125-134).  points: (N, 3) / (M, 3) numpy or tensors."""
    return chamfer_distance_async(points1, points2, num_points,
                                  device=device)()


def chamfer_distance_async(points1, points2,
                           num_points: Optional[int] = None,
                           pad_to: Optional[int] = None, device=None):
    """Launch the bidirectional sweep and return a () -> float handle; the
    eval loop reads it one sample later.

    ``device``: where the sweep runs (default: points1's device if it is a
    tensor, else the CPU).  ``pad_to``: pad BOTH clouds with sentinels to
    this size (rounded up to the chunk) and take masked means over the true
    counts, so every call of an eval loop sweeps one shape (the JAX version
    does this to share one compiled executable; the port keeps the same
    sizes, and with them the ``P % chunk`` branch).  Sentinel rows never win
    a real row's minimum (their distances are ~1e16)."""
    if device is None:
        device = points1.device if torch.is_tensor(points1) else "cpu"
    p1 = _as_points(points1, device)
    p2 = _as_points(points2, device)
    impl = get_chamfer_impl()
    n1, n2 = p1.shape[0], p2.shape[0]
    if pad_to is not None:
        chunk = _chunk_for(impl, pad_to)
        P = max(pad_to, n1, n2)
        P += (-P) % chunk
        p1p, p2p = _pad(p1, P), _pad(p2, P)
        pair_impl = getattr(impl, "pair", None)
        if pair_impl is not None and P % chunk == 0:
            d1, d2 = pair_impl(p1p, p2p, chunk=chunk)
        else:
            d1 = impl(p1p, p2p, chunk=chunk)
            d2 = impl(p2p, p1p, chunk=chunk)
        s1, s2 = d1[:n1].sum(), d2[:n2].sum()
    else:
        chunk = _chunk_for(impl, max(n1, n2))
        d1 = impl(p1, _pad(p2, n2 + (-n2) % chunk), chunk=chunk)
        d2 = impl(p2, _pad(p1, n1 + (-n1) % chunk), chunk=chunk)
        s1, s2 = d1.sum(), d2.sum()
    den1, den2 = (n1, n2) if num_points is None else (num_points,) * 2
    return lambda: float(s1) / den1 + float(s2) / den2


def device_voxel_counts(pcd_pred, pcd_gt, grid_size: float):
    """Unique-voxel occupancy counts (n_pred, n_gt, tp) as int64 tensors on
    the clouds' device: the three counts ``voxel_metrics_sparse`` derives
    with np.unique / intersect1d, and so the reference's dense IoU / P / R.

    Both clouds' per-axis voxel indices, tagged with a cloud flag (pred 0,
    gt 1), are sorted by (i0, i1, i2, flag).  jax.lax.sort(num_keys=4) has
    no torch counterpart: the flag order is the concatenation order already,
    so three stable sorts by i2, then i1, then i0 give the same order.  In
    each voxel's run the pred entries precede the gt entries, so

      n_pred = # flag-0 entries that start a run
      n_gt   = # flag-1 entries that start a run or follow a flag-0 entry
      tp     = # 0 -> 1 flag steps inside a run (voxels both clouds occupy)

    Indices stay per axis (never linearised), so no extent can overflow.
    ((pc - min) / grid).to(int32) truncates toward zero, which equals floor
    because the operands are >= 0, as in the reference's astype(int)."""
    allp = torch.cat([pcd_pred, pcd_gt])
    mn = allp.amin(0)
    idx = ((allp - mn) / grid_size).to(torch.int32)
    flag = torch.cat([
        torch.zeros(pcd_pred.shape[0], dtype=torch.int32, device=allp.device),
        torch.ones(pcd_gt.shape[0], dtype=torch.int32, device=allp.device)])
    perm = torch.arange(allp.shape[0], device=allp.device)
    for axis in (2, 1, 0):
        perm = perm[torch.argsort(idx[perm, axis], stable=True)]
    s = idx[perm]
    sf = flag[perm]
    same = (s[1:] == s[:-1]).all(dim=1)
    true1 = torch.ones(1, dtype=torch.bool, device=allp.device)
    newkey = torch.cat([true1, ~same])
    prev0 = torch.cat([~true1, sf[:-1] == 0])
    n_pred = ((sf == 0) & newkey).sum()
    n_gt = ((sf == 1) & (newkey | prev0)).sum()
    tp = (same & (sf[:-1] == 0) & (sf[1:] == 1)).sum()
    return n_pred, n_gt, tp
