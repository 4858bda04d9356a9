"""Training loop: per-iteration LR, the train step, metric logging (port of
tulip_tpu/train/engine.py).

Parity target: train_one_epoch (tulip/engine_upsampling.py:46-124): the
per-iteration warmup-cosine LR, set when data_iter_step % accum_iter == 0;
the NaN abort (exit code 1); MetricLogger every 20 iterations; TensorBoard
scalars on the epoch_1000x axis.  Losses are read one step late: the
previous step's loss tensors are read back after the next step is
launched, so the host waits on the card once per step at most.

Under data parallel each rank draws the drop-path and dropout masks of the
global batch from the same (seed, epoch) generator and keeps its own rows
(``layers.RankDraws``); under W-axis sequence parallel the rows of its
data index, which its seq ranks share (``train_step.mesh``), and the
sharded forward keeps its W shard's columns of the dropout masks.  The step
returns losses already averaged over the ranks, so the NaN abort fires on
every rank at the same step.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..models.layers import RankDraws
from ..parallel import dist
from ..utils.logger import MetricLogger, SmoothedValue
from ..utils.lr_sched import lr_at_epoch


def batch_to_device(array, device, pin_mem: bool) -> torch.Tensor:
    """A host numpy batch as a float32 tensor on ``device``.  On a CUDA
    device with ``pin_mem`` (the ``--pin_mem`` default) the batch is staged
    in page-locked memory and the copy does not block the host; else the
    copy is a plain blocking one: ``non_blocking`` on pageable memory would
    only look asynchronous.  On the CPU nothing is copied."""
    t = torch.from_numpy(np.ascontiguousarray(array, np.float32))
    if torch.device(device).type == "cuda" and pin_mem:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train_one_epoch(train_step, data_loader, epoch: int, *, device,
                    log_writer=None, args=None):
    """Run one epoch of ``train_step`` (from make_train_step) over
    ``data_loader``, which yields (low, high) dicts of numpy batches under
    "sample".  Returns the averaged meters as a dict."""
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter('lr', SmoothedValue(window_size=1,
                                                fmt='{value:.6f}'))
    header = 'Epoch: [{}]'.format(epoch)
    print_freq = 20
    accum_iter = args.accum_iter
    pin_mem = getattr(args, "pin_mem", True)   # the parser's default

    if log_writer is not None:
        print('log_dir: {}'.format(log_writer.logdir))

    # the epoch's drop-path and dropout draws: one generator on the device,
    # seeded from (seed, epoch) alike on every rank, in place of the JAX
    # package's fold_in(key, epoch); under data parallel each rank keeps its
    # rows of the global batch's draws, under sequence parallel its data
    # index's
    seed = np.random.SeedSequence([int(args.seed), epoch]).generate_state(1)
    generator = torch.Generator(device=device).manual_seed(int(seed[0]))
    if dist.get_world_size() > 1:
        mesh = getattr(train_step, "mesh", None)
        generator = (RankDraws(generator, dist.get_rank(),
                               dist.get_world_size()) if mesh is None else
                     RankDraws(generator, mesh.data_index, mesh.dp))
    num_steps = len(data_loader)
    lr = 0.0
    pending = None  # (iter_step, lr, total_loss, pixel_loss) of the last step

    def drain(p):
        it, it_lr, tl, pl = p
        total_loss_value = tl.item()
        pixel_loss_value = pl.item()
        if not math.isfinite(total_loss_value):
            print("Total Loss is {}, stopping training".format(
                total_loss_value))
            print("Pixel Loss is {}, stopping training".format(
                pixel_loss_value))
            sys.exit(1)
        metric_logger.update(loss=total_loss_value)
        metric_logger.update(lr=it_lr)
        total_loss_value_reduce = dist.all_reduce_mean(total_loss_value)
        pixel_loss_value_reduce = dist.all_reduce_mean(pixel_loss_value)
        if log_writer is not None and (it + 1) % accum_iter == 0:
            # epoch_1000x x-axis calibrates curves across batch sizes
            # (reference: engine:110-118)
            epoch_1000x = int((it / num_steps + epoch) * 1000)
            if args.log_transform or getattr(args, "depth_scale_loss", False):
                log_writer.add_scalar('train_loss_total',
                                      total_loss_value_reduce, epoch_1000x)
            log_writer.add_scalar('train_loss_pixel',
                                  pixel_loss_value_reduce, epoch_1000x)
            log_writer.add_scalar('lr', lr, epoch_1000x)

    for data_iter_step, (low, high) in enumerate(
            metric_logger.log_every(data_loader, print_freq, header)):
        # per-iteration LR (reference: engine:69-70, lr_sched.py:9-21)
        if data_iter_step % accum_iter == 0:
            lr = lr_at_epoch(data_iter_step / num_steps + epoch,
                             args.lr, args.min_lr, args.warmup_epochs,
                             args.epochs)
        total_loss, pixel_loss = train_step(
            batch_to_device(low["sample"], device, pin_mem),
            batch_to_device(high["sample"], device, pin_mem), lr, generator)
        if pending is not None:
            drain(pending)
        pending = (data_iter_step, lr, total_loss, pixel_loss)

    if pending is not None:
        drain(pending)

    metric_logger.synchronize_between_processes()
    print("Averaged stats:", metric_logger)
    return {k: meter.global_avg for k, meter in metric_logger.meters.items()}
