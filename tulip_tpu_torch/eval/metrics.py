"""Evaluation metrics on the device: the bidirectional chamfer distance and
unique-voxel occupancy counts (port of tulip_tpu/eval/metrics.py).

The chamfer distance is mean_i min_j |p1_i - p2_j|^2 + mean_j min_i
|p1_i - p2_j|^2 (squared distances, as the reference's CUDA extension), swept
by the impl that ``ops.chamfer.get_chamfer_impl`` names.  The numpy host
helpers at the end (``voxel_metrics_sparse``, ``calculate_metrics`` ...) are
copies of the JAX package's: the same numpy code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.chamfer import get_chamfer_impl

_PAD_VALUE = 1.0e8  # sentinel coordinate for chunk padding; distances ~1e16


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


def _sweep_device(points1, device) -> torch.device:
    """``device``, else points1's device if it is a tensor, else the GPU:
    host arrays sweep on the card unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(points1):
        return points1.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device cuda (the default for host arrays), but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain version on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def chamfer_distance(points1, points2, num_points: Optional[int] = None,
                     device=None) -> float:
    """Bidirectional squared-NN chamfer, mean(d1) + mean(d2) (reference:
    evaluation.py:125-134).  points: (N, 3) / (M, 3) numpy or tensors;
    ``device`` as :func:`chamfer_distance_async`."""
    return chamfer_distance_async(points1, points2, num_points,
                                  device=device)()


def chamfer_distance_async(points1, points2,
                           num_points: Optional[int] = None,
                           pad_to: Optional[int] = None, device=None):
    """Launch the bidirectional sweep and return a () -> float handle; the
    eval loop reads it one sample later.

    ``device``: where the sweep runs (default: points1's device if it is a
    tensor, else the GPU, which must be there: nothing falls back to the
    CPU; ``device="cpu"`` runs the plain version).  ``pad_to``: pad BOTH
    clouds with sentinels to this size (rounded up to the chunk) and take
    masked means over the true counts, so every call of an eval loop
    sweeps one shape (the JAX version does this to share one compiled
    executable; the port keeps the same sizes, and with them the
    ``P % chunk`` branch).  Sentinel rows never win a real row's minimum
    (their distances are ~1e16)."""
    device = _sweep_device(points1, device)
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


# ---------------------------------------------------------------------------
# numpy host metrics (copies of tulip_tpu/eval/metrics.py)
# ---------------------------------------------------------------------------

def mean_absolute_error(pred_img, gt_img) -> float:
    """(reference: evaluation.py:119-122)"""
    return float(np.abs(np.asarray(pred_img) - np.asarray(gt_img)).mean())


def voxelize_point_cloud(point_cloud: np.ndarray, grid_size: float,
                         min_coord: np.ndarray, max_coord: np.ndarray) -> np.ndarray:
    """Dynamic-extent boolean voxel grid (reference: evaluation.py:148-159).
    Stays on host: extents are data-dependent (dynamic shapes) and the work is
    O(points)."""
    dimensions = ((max_coord - min_coord) / grid_size).astype(int) + 1
    voxel_grid = np.zeros(dimensions, dtype=bool)
    indices = ((point_cloud - min_coord) / grid_size).astype(int)
    voxel_grid[tuple(indices.T)] = True
    return voxel_grid


def voxel_metrics_sparse(pcd_pred: np.ndarray, pcd_gt: np.ndarray,
                         grid_size: float, min_coord: np.ndarray,
                         max_coord: np.ndarray):
    """IoU / precision / recall, bit-identical to
    ``calculate_metrics(voxelize_point_cloud(pred), voxelize_point_cloud(gt))``
    but via sparse set ops over linearized voxel keys.

    The dense path (reference semantics, evaluation.py:148-175) materializes
    two boolean grids of dynamic extent — at real scan extents (~90 m at
    0.1 m cells) that is ~GBs of zeroed memory PER SAMPLE.  Occupancy counts only
    depend on the SET of occupied cells, so unique()/intersect1d() on int64
    keys gives the exact same three numbers in O(N log N) over N=H*W points.
    """
    dims = ((np.asarray(max_coord) - np.asarray(min_coord))
            / grid_size).astype(int) + 1
    d1, d2 = np.int64(dims[1]), np.int64(dims[2])

    def _keys(pc):
        idx = ((pc - min_coord) / grid_size).astype(np.int64)
        return np.unique((idx[:, 0] * d1 + idx[:, 1]) * d2 + idx[:, 2])

    kp = _keys(pcd_pred)
    kg = _keys(pcd_gt)
    tp = np.intersect1d(kp, kg, assume_unique=True).size
    union = kp.size + kg.size - tp
    # degenerate empty clouds (e.g. a fully noise-filtered prediction): the
    # dense reference path divides 0/0 into nan with a RuntimeWarning
    # instead of raising — match that so one bad sample can't abort a long
    # eval run
    nan = float("nan")
    return (tp / union if union else nan,
            tp / kp.size if kp.size else nan,
            tp / kg.size if kg.size else nan)


def calculate_metrics(voxel_grid_predicted: np.ndarray,
                      voxel_grid_ground_truth: np.ndarray):
    """IoU / precision / recall from boolean grids
    (reference: evaluation.py:161-175)."""
    intersection = np.logical_and(voxel_grid_predicted, voxel_grid_ground_truth)
    union = np.logical_or(voxel_grid_predicted, voxel_grid_ground_truth)

    iou = np.sum(intersection) / np.sum(union)
    true_positive = np.sum(intersection)
    false_positive = np.sum(voxel_grid_predicted) - true_positive
    false_negative = np.sum(voxel_grid_ground_truth) - true_positive
    precision = true_positive / (true_positive + false_positive)
    recall = true_positive / (true_positive + false_negative)
    return iou, precision, recall


def inverse_huber_loss(output, target):
    """(reference: evaluation.py:177-180; dead code kept for API parity)"""
    absdiff = np.abs(np.asarray(output) - np.asarray(target))
    C = 0.2 * absdiff.max()
    return np.where(absdiff < C, absdiff, (absdiff * absdiff + C * C) / (2 * C))


def depth_wise_unconcate(imgs: np.ndarray) -> np.ndarray:
    """Channels -> interleaved rows (reference: evaluation.py:136-145; dead
    code kept for API parity).  imgs: (B, C, H, W) -> (B, 1, H*C, W)."""
    b, c, h, w = imgs.shape
    new_imgs = np.zeros((b, h * c, w), dtype=imgs.dtype)
    for i in range(c):
        new_imgs[:, range(i, h * c + i, c), :] = imgs[:, i, :, :]
    return new_imgs.reshape(b, 1, h * c, w)
