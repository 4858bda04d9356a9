"""Evaluation engines: plain eval and Monte-Carlo-dropout eval (port of
tulip_tpu/eval/engine.py).

Parity targets: evaluate (tulip/engine_upsampling.py:126-356) and MCdrop
(engine:361-608).  The forward, de-log, range gating and loss map run on
the device, and by default so do the per-sample metrics (projection, the
bidirectional chamfer sweep, voxel counts; one packed stats read per
sample).  Metric-order parity quirks preserved:

- MAE is computed on the gated/de-logged prediction BEFORE low-res row
  re-injection (engine:192-193 vs :215).
- range gates: carla/kitti 2/80..1, durlar 0.3/120..1 in evaluate
  (engine:183-188); MCdrop's kitti gate is 0..1 (engine:442).
- MCdrop std uses Bessel's correction (torch.std default, engine:423) and
  zeroes pixels where std > threshold * mean (engine:424-426).
- metrics only accumulate when a log_writer is present (engine:174, 428).
  Under data parallel each rank evaluates its own stride of the val set
  (as the JAX entry shards it) and only rank 0, the one rank with a
  log_writer, computes metrics and writes the results file and the PLY
  clouds: the reference's quirk kept (SURVEY.md:197-200), its results
  cover rank 0's share.  No two ranks write the same file.  Under W-axis
  sequence parallel (``sp_forward``: parallel/sp.py:make_sp_eval_forward)
  every rank of a data index runs each scan's forward on its W shard and
  receives the joined pred; rank 0 alone goes on to the metrics.  MCdrop's
  chunk generators are seeded alike on every rank, and each shard keeps
  its columns of the masks, so the ranks draw what one process draws.
- keep_close_scan zeroes ranges > 0.25 for durlar in evaluate and for
  kitti in MCdrop only.

Not ported: ``_warm_metrics`` and the ``_FWD_CACHE`` jit cache.  Both
exist to avoid TPU remote compiles; PyTorch runs eagerly and compiles
nothing per shape.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import tqdm

from ..models.tulip import apply_model
from ..ops.chamfer import get_chamfer_impl
from ..parallel import dist
from ..utils.writer import colorize_range_image, write_ply
from .geometry import (img_to_pcd_carla, img_to_pcd_carla_torch,
                       img_to_pcd_durlar, img_to_pcd_durlar_torch,
                       img_to_pcd_kitti, img_to_pcd_kitti_torch)
from .metrics import (chamfer_distance_async, device_voxel_counts,
                      voxel_metrics_sparse)


def _use_device_metrics() -> bool:
    """On-device per-sample metric path; TULIP_TPU_HOST_METRICS=1 selects
    the host numpy path."""
    return os.environ.get("TULIP_TPU_HOST_METRICS", "0") != "1"


_GATES = {  # evaluate-path gates (engine:183-188)
    "carla": (2 / 80, 1.0),
    "durlar": (0.3 / 120, 1.0),
    "kitti": (2 / 80, 1.0),
}
_GATES_MC = {  # MCdrop-path gates (engine:437-442)
    "carla": (2 / 80, 1.0),
    "durlar": (0.3 / 120, 1.0),
    "kitti": (0.0, 1.0),
}


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _gate_and_loss(pred, high, low, log_transform, lo, hi):
    """De-log, gate and loss map (device side of engine:183-193)."""
    pred = pred.float()
    high32 = high.float()
    low32 = low.float()
    if log_transform:
        pred = torch.expm1(pred)
        high32 = torch.expm1(high32)
        low32 = torch.expm1(low32)
    if lo is not None:
        pred = torch.where((pred >= lo) & (pred <= hi), pred,
                           torch.zeros_like(pred))
    loss_map = (pred - high32).abs()
    return pred, high32, low32, loss_map, loss_map.mean()


def _make_eval_forward(model, dataset: str, log_transform: bool, gates,
                       compute_dtype, sp_forward=None):
    """Forward + de-log + gate + loss map (device side of engine:168-193).
    ``sp_forward(low) -> pred`` optionally replaces the model forward."""
    lo, hi = gates.get(dataset, (None, None))

    def fwd(low, high):
        if sp_forward is not None:
            pred = sp_forward(low)
        else:
            pred, _, _ = apply_model(model, low, high, mode="eval",
                                     compute_dtype=compute_dtype)
        return _gate_and_loss(pred, high, low, log_transform, lo, hi)

    return fwd


def _make_mc_forward(model, compute_dtype, sp_forward=None):
    """One batch of dropout-active forwards (engine:409-421; model called
    with mc_drop=True, tulip.py:733-734), the dropout drawn from
    ``generator``.  ``sp_forward(low_tiled, generator) -> pred``
    optionally replaces the model forward (sequence parallel: each W shard
    keeps its columns of the masks ``generator`` draws for the whole
    scans)."""

    def fwd(low_tiled, generator=None):
        if sp_forward is not None:
            return sp_forward(low_tiled, generator).float()
        return apply_model(model, low_tiled, None, mode="mc", mc_drop=True,
                           compute_dtype=compute_dtype,
                           generator=generator).float()

    return fwd


def _project(dataset: str, img: np.ndarray, mc: bool = False) -> np.ndarray:
    if dataset == "carla":
        return img_to_pcd_carla(img, maximum_range=80)
    if dataset == "kitti":
        return img_to_pcd_kitti(img, maximum_range=80)
    if dataset == "durlar":
        # MCdrop calls img_to_pcd_durlar without maximum_range (default 120)
        # (engine:509-510): the same value
        return img_to_pcd_durlar(img, maximum_range=120)
    raise NotImplementedError(f"Cannot find the dataset: {dataset}")


def _keep_close(dataset, args, mc: bool) -> bool:
    return bool(args.keep_close_scan) and (
        (dataset == "durlar" and not mc) or (dataset == "kitti" and mc))


def _sample_3d_metrics(dataset, pred_img, images_high_res, images_low_res,
                       h_high_res, downsampling_factor, args, mc: bool,
                       device, defer: bool = False):
    """Host-side per-sample 3D metric path (engine:205-276), selected by
    TULIP_TPU_HOST_METRICS=1.  Returns (loss_low_res_part, chamfer, iou,
    precision, recall, f1, pcd_pred, pcd_gt) and mutates pred_img with the
    low-res row re-injection.  The chamfer sweep runs on ``device``;
    ``defer=True`` returns a zero-arg closure that reads it later."""
    if dataset == "carla" and tuple(args.img_size_low_res)[1] != tuple(
            args.img_size_high_res)[1]:
        loss_low_res_part = 0.0
    else:
        low_res_index = range(0, h_high_res, downsampling_factor)
        pred_low_res_part = pred_img[low_res_index, :]
        loss_low_res_part = float(
            np.abs(pred_low_res_part - images_low_res).mean())
        pred_img[low_res_index, :] = images_low_res

    if _keep_close(dataset, args, mc):
        pred_img[pred_img > 0.25] = 0
        images_high_res[images_high_res > 0.25] = 0

    pcd_pred = _project(dataset, pred_img, mc)
    pcd_gt = _project(dataset, images_high_res, mc)

    hh, ww = tuple(args.img_size_high_res)
    chamfer_handle = chamfer_distance_async(pcd_gt, pcd_pred, pad_to=hh * ww,
                                            device=device)

    pcd_all = np.vstack((pcd_pred, pcd_gt))
    iou, precision, recall = voxel_metrics_sparse(
        pcd_pred, pcd_gt, args.grid_size, np.min(pcd_all, axis=0),
        np.max(pcd_all, axis=0))
    f1 = 2 * (precision * recall) / (precision + recall)

    def finish():
        return (loss_low_res_part, chamfer_handle(), iou, precision, recall,
                f1, pcd_pred, pcd_gt)

    return finish if defer else finish()


def _make_device_metrics(dataset: str, args, mc: bool):
    """The per-sample metric step on the device (engine:205-276): low-res
    row re-injection + low-res-part MAE + keep_close gating + projection +
    both chamfer directions + unique-voxel counts.  Returns a dict with the
    packed ``stats`` vector [loss_low, chamfer, n_pred, n_gt, tp, mae] (one
    device read per sample) and the images the TB logging steps fetch.
    Index math runs in fp32 on the device (the host path's is float64):
    voxel boundary flips move iou/precision/recall by ~1e-5 relative."""
    impl = get_chamfer_impl()
    hh, ww = tuple(args.img_size_high_res)
    hl, wl = tuple(args.img_size_low_res)
    P = hh * ww
    pref = getattr(impl, "preferred_chunk", 4096)
    chunk = pref if P >= pref else 512
    factor = hh // hl
    grid_size = float(args.grid_size)
    keep_close = _keep_close(dataset, args, mc)
    skip_inject = dataset == "carla" and wl != ww
    pair_impl = getattr(impl, "pair", None)

    def project(img):
        if dataset == "carla":
            return img_to_pcd_carla_torch(img, maximum_range=80)
        if dataset == "kitti":
            return img_to_pcd_kitti_torch(img, maximum_range=80)
        return img_to_pcd_durlar_torch(img, maximum_range=120)

    def metrics_fn(pred, high32, low32):
        p = pred.reshape(hh, ww)
        h = high32.reshape(hh, ww)
        if skip_inject:
            loss_low = torch.zeros((), device=p.device)
            p2 = p
        else:
            l = low32.reshape(hl, ww)
            loss_low = (p[::factor, :] - l).abs().mean()
            p2 = p.clone()
            p2[::factor, :] = l
        h2 = h
        if keep_close:
            p2 = torch.where(p2 > 0.25, torch.zeros_like(p2), p2)
            h2 = torch.where(h2 > 0.25, torch.zeros_like(h2), h2)
        pcd_pred = project(p2)
        pcd_gt = project(h2)
        if pair_impl is not None and P % chunk == 0:
            d1, d2 = pair_impl(pcd_gt, pcd_pred, chunk=chunk)
        else:
            d1 = impl(pcd_gt, pcd_pred, chunk=chunk)   # gt -> pred
            d2 = impl(pcd_pred, pcd_gt, chunk=chunk)   # pred -> gt
        chamfer = d1.mean() + d2.mean()
        n_pred, n_gt, tp = device_voxel_counts(pcd_pred, pcd_gt, grid_size)
        # stats[5] re-derives the forward's mae over the same post-gate
        # arrays, so the loop reads one vector per sample
        stats = torch.stack([loss_low, chamfer, n_pred.float(), n_gt.float(),
                             tp.float(), (p - h).abs().mean()])
        return dict(stats=stats, pred_inj=p2, high_gated=h2)

    return metrics_fn


def _voxel_ratios(n_pred: int, n_gt: int, tp: int):
    """IoU / precision / recall / f1 from occupancy counts, with the dense
    reference path's nan-on-empty semantics."""
    union = n_pred + n_gt - tp
    nan = float("nan")
    iou = tp / union if union else nan
    precision = tp / n_pred if n_pred else nan
    recall = tp / n_gt if n_gt else nan
    pr = precision + recall
    f1 = 2 * (precision * recall) / pr if pr else nan
    return iou, precision, recall, f1


def _log_sample(log_writer, local_step, global_step, images_high_res,
                pred_img, loss_map, mae, loss_low_res_part, chamfer_dist,
                iou, precision, recall, pcd_pred, pcd_gt, args, pcd_dirname):
    """TB image grid + scalars + optional .ply export (engine:285-329)."""
    lm = _to_numpy(loss_map).squeeze()
    lm = (lm - lm.min()) / (lm.max() - lm.min() + 1e-8)
    grid = np.concatenate([
        colorize_range_image(images_high_res),
        colorize_range_image(np.asarray(pred_img)),
        colorize_range_image(lm, "jet"),
    ], axis=1)
    log_writer.add_image('gt - pred', grid, local_step)
    log_writer.add_scalar('Test/mae_all', mae, local_step)
    log_writer.add_scalar('Test/mae_low_res', loss_low_res_part, local_step)
    log_writer.add_scalar('Test/chamfer_dist', chamfer_dist, local_step)
    log_writer.add_scalar('Test/iou', iou, local_step)
    log_writer.add_scalar('Test/precision', precision, local_step)
    log_writer.add_scalar('Test/recall', recall, local_step)

    if args.save_pcd and local_step % 4 == 0:
        pcd_outputpath = os.path.join(args.output_dir, pcd_dirname)
        os.makedirs(pcd_outputpath, exist_ok=True)
        pred_color = np.zeros_like(pcd_pred)
        pred_color[:, 0] = 255
        gt_color = np.zeros_like(pcd_gt)
        gt_color[:, 2] = 255
        write_ply(os.path.join(pcd_outputpath, f"pred_{global_step}.ply"),
                  pcd_pred, pred_color)
        write_ply(os.path.join(pcd_outputpath, f"gt_{global_step}.ply"),
                  pcd_gt, gt_color)


def _finalize(evaluation_metrics, totals, global_step, log_writer, args,
              results_name):
    if not dist.is_main_process():
        return evaluation_metrics
    evaluation_file_path = os.path.join(args.output_dir, results_name)
    with open(evaluation_file_path, 'w') as f:
        json.dump(evaluation_metrics, f)
    print(f'Dictionary saved to {evaluation_file_path}')

    if log_writer is not None and global_step > 0:
        for k in ('iou', 'cd', 'loss', 'f1', 'precision', 'recall'):
            log_writer.add_scalar(f'Metrics/test_average_{k}',
                                  totals[k] / global_step, 0)
    return evaluation_metrics


class _Recorder:
    """Per-sample accumulation shared by both engines (engine:196-282):
    the results lists, the running totals and the TB logging steps."""

    def __init__(self, log_writer, args, pcd_dirname):
        self.log_writer = log_writer
        self.args = args
        self.pcd_dirname = pcd_dirname
        self.local_step = 0
        self.totals = dict(loss=0.0, iou=0.0, cd=0.0, f1=0.0, precision=0.0,
                           recall=0.0)
        self.metrics = {k: [] for k in ('mae', 'chamfer_dist', 'iou',
                                        'precision', 'recall', 'f1')}

    def add(self, step, mae, loss_low_res_part, chamfer_dist, iou,
            precision, recall, f1, log_arrays):
        m = self.metrics
        m['mae'].append(mae)
        m['chamfer_dist'].append(float(chamfer_dist))
        m['iou'].append(iou)
        m['precision'].append(precision)
        m['recall'].append(recall)
        m['f1'].append(f1)
        if step % 100 == 0 or step == 1:
            images_high_res, pred_img, loss_map, pcd_pred, pcd_gt = \
                log_arrays()
            _log_sample(self.log_writer, self.local_step, step,
                        images_high_res, pred_img, loss_map, mae,
                        loss_low_res_part, chamfer_dist, iou, precision,
                        recall, pcd_pred, pcd_gt, self.args,
                        self.pcd_dirname)
            self.local_step += 1
        t = self.totals
        t['iou'] += iou
        t['cd'] += float(chamfer_dist)
        t['loss'] += mae
        t['f1'] += f1
        t['precision'] += precision
        t['recall'] += recall


def _make_process(dataset, args, mc, metrics_fn, rec, h_high_res,
                  downsampling_factor, device):
    """process(step, outs) -> complete(): launches the sample's metrics and
    returns the closure that reads them (device path: one stats read)."""

    def process_device(step, outs):
        # the forward's mae scalar is ignored: stats[5] re-derives it
        pred, high32, low32, loss_map, _mae = outs
        dm = metrics_fn(pred, high32, low32)

        def complete():
            sv = _to_numpy(dm['stats'])
            loss_low, chamfer = float(sv[0]), float(sv[1])
            n_pred, n_gt, tp = int(sv[2]), int(sv[3]), int(sv[4])
            iou, precision, recall, f1 = _voxel_ratios(n_pred, n_gt, tp)

            def log_arrays():
                images_high_res = _to_numpy(dm['high_gated'])
                pred_img = _to_numpy(dm['pred_inj'])
                return (images_high_res, pred_img, loss_map,
                        _project(dataset, pred_img, mc),
                        _project(dataset, images_high_res, mc))

            rec.add(step, float(sv[5]), loss_low, chamfer, iou, precision,
                    recall, f1, log_arrays)

        return complete

    def process_host(step, outs):
        pred, high32, low32, loss_map, mae = outs
        mae = float(mae)
        images_high_res = _to_numpy(high32).squeeze()
        images_low_res = _to_numpy(low32).squeeze()
        pred_img = np.array(_to_numpy(pred)).squeeze()
        finish3d = _sample_3d_metrics(
            dataset, pred_img, images_high_res, images_low_res, h_high_res,
            downsampling_factor, args, mc=mc, device=device, defer=True)

        def complete():
            (loss_low_res_part, chamfer_dist, iou, precision, recall, f1,
             pcd_pred, pcd_gt) = finish3d()
            rec.add(step, mae, loss_low_res_part, chamfer_dist, iou,
                    precision, recall, f1,
                    lambda: (images_high_res, pred_img, loss_map, pcd_pred,
                             pcd_gt))

        return complete

    return process_device if metrics_fn is not None else process_host


def _run_loop(data_loader, device, step_fn, process, log_writer):
    """Two-deep pipeline: sample k+1's forward is launched before sample k's
    metrics, and sample k's stats are read one iteration later still, so
    the device queue stays full while the host reads and logs (CUDA
    launches return at once; only the reads wait).  Returns the step
    count."""
    global_step = 0
    pending = None
    pending_fin = None
    for batch in tqdm.tqdm(data_loader):
        low = torch.as_tensor(batch[0]['sample']).to(device)
        high = torch.as_tensor(batch[1]['sample']).to(device)
        global_step += 1
        outs = step_fn(global_step, low, high)
        if log_writer is None:
            continue  # parity: metrics only on the logging rank (engine:174)
        if pending is not None:
            fin = process(*pending)
            if pending_fin is not None:
                pending_fin()
            pending_fin = fin
        pending = (global_step, outs)
    if pending is not None:
        fin = process(*pending)
        if pending_fin is not None:
            pending_fin()
        fin()
    return global_step


def evaluate(data_loader, model, log_writer, args=None, *, device,
             compute_dtype=torch.float32, sp_forward=None):
    """Plain evaluation (reference: engine_upsampling.py:126-356).  ``model``
    holds its weights on ``device`` in ``compute_dtype``."""
    h_low_res = tuple(args.img_size_low_res)[0]
    h_high_res = tuple(args.img_size_high_res)[0]
    dataset = args.dataset_select
    fwd = _make_eval_forward(model, dataset, args.log_transform, _GATES,
                             compute_dtype, sp_forward=sp_forward)
    metrics_fn = (_make_device_metrics(dataset, args, mc=False)
                  if (_use_device_metrics() and log_writer is not None)
                  else None)
    rec = _Recorder(log_writer, args, 'pcd')
    process = _make_process(dataset, args, False, metrics_fn, rec,
                            h_high_res, h_high_res // h_low_res, device)
    with torch.no_grad():
        global_step = _run_loop(data_loader, device,
                                lambda step, low, high: fwd(low, high),
                                process, log_writer)
    return _finalize(rec.metrics, rec.totals, global_step, log_writer, args,
                     'results.txt')


def _chunk_generator(seed, step: int, chunk: int, device) -> torch.Generator:
    """The dropout draws of MC chunk ``chunk`` of sample ``step``."""
    state = np.random.SeedSequence([int(seed), step, chunk]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def MCdrop(data_loader, model, log_writer, args=None, *, device,
           compute_dtype=torch.float32, sp_forward=None):
    """Monte-Carlo-dropout evaluation (reference: engine:361-608).

    Runs num_mcdropout_iterations dropout-active forwards in ceil(n / 8)
    chunks of 8, averages, and zeroes pixels whose std exceeds threshold *
    mean.  Chunk c of sample ``step`` draws its dropout from a generator on
    the device seeded from (args.seed, step, c), so a run repeats bit for
    bit under one seed.  The dropout rates are the model config's
    (``model_config(drop_rate=..., attn_drop_rate=...)``); the shipped
    configs have both at 0, so there the passes are identical, std == 0,
    and no pixel is removed (SURVEY.md 7.3.8).

    At dropout rate 0 ONE forward broadcast to the iteration count feeds the
    same mean/std/removal computation the full loop would see (identical
    metrics, ~iteration x less device work); TULIP_TPU_MC_FULL=1 forces the
    full loop.
    """
    iteration = args.num_mcdropout_iterations
    iteration_batch = 8
    noise_threshold = args.noise_threshold
    if iteration <= iteration_batch:
        raise ValueError(f"num_mcdropout_iterations must exceed "
                         f"{iteration_batch}, got {iteration}")
    deterministic_mc = (model.cfg.drop_rate == 0.0
                        and model.cfg.attn_drop_rate == 0.0
                        and os.environ.get("TULIP_TPU_MC_FULL") != "1")

    h_low_res = tuple(args.img_size_low_res)[0]
    h_high_res = tuple(args.img_size_high_res)[0]
    dataset = args.dataset_select
    mc_fwd = _make_mc_forward(model, compute_dtype, sp_forward=sp_forward)
    lo, hi = _GATES_MC.get(dataset, (None, None))

    def postprocess(preds, low, high):
        # preds: (iteration, C, H, W) stacked MC samples
        pred_mean = preds.mean(0, keepdim=True)
        pred_std = preds.std(0, keepdim=True, correction=1)
        noise_removal = pred_std > noise_threshold * pred_mean
        pred = torch.where(noise_removal, torch.zeros_like(pred_mean),
                           pred_mean)
        return _gate_and_loss(pred, high, low, args.log_transform, lo, hi)

    def step_fn(step, low, high):
        if deterministic_mc:
            single = mc_fwd(low)
            preds = single[0].expand(iteration, *single.shape[1:])
        else:
            n_chunks = math.ceil(iteration / iteration_batch)
            tiled = low.repeat(iteration_batch, 1, 1, 1)
            preds = torch.cat([mc_fwd(tiled, _chunk_generator(
                args.seed, step, c, low.device)) for c in range(n_chunks)])
            preds = preds[:iteration]
        return postprocess(preds, low, high)

    metrics_fn = (_make_device_metrics(dataset, args, mc=True)
                  if (_use_device_metrics() and log_writer is not None)
                  else None)
    rec = _Recorder(log_writer, args, 'pcd_mc_drop')
    process = _make_process(dataset, args, True, metrics_fn, rec,
                            h_high_res, h_high_res // h_low_res, device)
    with torch.no_grad():
        global_step = _run_loop(data_loader, device, step_fn, process,
                                log_writer)
    return _finalize(rec.metrics, rec.totals, global_step, log_writer, args,
                     'results_mcdrop.txt')
