"""Command-line entry point of the port: flag- and workflow-compatible with
the reference (tulip/main_lidar_upsampling.py:34-329) and with the JAX
package's entry, step for step, on PyTorch with one CUDA device a process.

    python3 -m tulip_tpu_torch.main_lidar_upsampling <the flags of bash_scripts/*.sh>
    torchrun --nproc_per_node=N -m tulip_tpu_torch.main_lidar_upsampling <flags>

Train: datasets and loaders, model from the flags, AdamW over fp32 master
weights with bf16 compute (``--precision``), ``--resume``, one
``train_one_epoch`` per epoch, ``checkpoint-{epoch}.pth`` every
``--save_frequency`` epochs and at the last, one JSON line per epoch in
``log.txt``.  ``--eval``: load the checkpoint that ``--output_dir`` names
(a ``.pth``, or a directory whose latest checkpoint is taken) and run
``evaluate`` or, with ``--mc_drop``, ``MCdrop``.

``--device`` chooses the device: ``cuda`` (the default) runs on the GPU and
raises if there is none; ``cpu`` runs the plain PyTorch versions of the
kernels.  Nothing falls back to the CPU by itself.

Under a launcher (torchrun, OpenMPI with ``--dist_on_itp``, SLURM) the N
ranks train data-parallel in one torch.distributed group joined at
``--dist_url`` (nccl for ``--device cuda`` on ``cuda:LOCAL_RANK``, gloo for
``--device cpu``; parallel/mesh.py): each rank loads its own stride of the
epoch and steps on ``--batch_size`` samples, the gradients are averaged
across the ranks, and the global batch (and the lr rule's effective batch)
is ``batch_size x N x accum_iter``.  Only rank 0 prints, logs and writes
checkpoints; every rank reads the same checkpoint on ``--resume`` and the
weights are then broadcast from rank 0.

``--sp_degree S`` lays the N ranks out as N / S data indices of S W shards
(rank = d·S + s, parallel/mesh.py:make_mesh; W-axis sequence parallel,
parallel/sp.py): the ranks of a data index load the same samples, each
takes its W slice of them, and the shards meet in halo exchanges.  The
global batch is then ``batch_size x N / S``.  S above the geometry's cap
(``sp.max_sp_degree``: every stage keeps two window columns a shard) is
clamped to it with a message; an S that does not divide N raises
ValueError.  ``--eval`` under S runs each scan's forward on the S ranks of
a data index and gathers the shards; rank 0 computes the metrics and
writes the results file while the others wait.  ``--mesh_shape`` may name
the layout: N, or N / S and S.
"""

import datetime
import json
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda (the default), but torch.cuda.is_available() "
                "is false; pass --device cpu to run the plain versions on "
                "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"--device takes cuda or cpu, got {name!r}")
    return device


def main(args):
    from tulip_tpu_torch.parallel.mesh import init_distributed_mode

    device = _device(args.device)   # no GPU: raise before joining a group
    init_distributed_mode(args)
    if args.gpu is not None:
        device = torch.device("cuda", args.gpu)
    try:
        _run(args, device)
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()


def _run(args, device):
    from tulip_tpu_torch.config import model_config_from_args
    from tulip_tpu_torch.data import generate_dataset
    from tulip_tpu_torch.data.pipeline import DataLoader, ShardedSampler
    from tulip_tpu_torch.eval.engine import MCdrop, evaluate
    from tulip_tpu_torch.models.tulip import TULIP, init_params
    from tulip_tpu_torch.ops.chamfer import set_default_chamfer_impl
    from tulip_tpu_torch.parallel import dist
    from tulip_tpu_torch.parallel.mesh import (check_mesh_shape, make_mesh,
                                               replicate)
    from tulip_tpu_torch.parallel.sp import (make_sp_eval_forward,
                                             make_sp_train_step,
                                             max_sp_degree)
    from tulip_tpu_torch.train.engine import train_one_epoch
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    from tulip_tpu_torch.utils import checkpoint as ckpt_util
    from tulip_tpu_torch.utils.writer import TBWriter, finish_wandb, init_wandb

    set_default_chamfer_impl(args.chamfer_impl)

    cfg = model_config_from_args(args)
    model = TULIP(cfg)

    # --sp_degree: W-axis sequence parallel.  Clamp to the geometry's cap
    # (every stage needs >= 2 window columns a W shard), as the JAX entry
    # does, rather than fail inside the model
    sp = getattr(args, 'sp_degree', 1) or 1
    if sp > 1:
        cap = max_sp_degree(model)
        if sp > cap:
            print(f"[tulip_tpu_torch] --sp_degree {sp} exceeds this model "
                  f"geometry's ceiling (every stage needs >= 2 window "
                  f"columns per W shard); clamping to {cap}")
            sp = cap
        args.sp_degree = sp
    mesh = make_mesh(sp)
    check_mesh_shape(getattr(args, 'mesh_shape', None), sp)

    print('job dir: {}'.format(os.path.dirname(os.path.realpath(__file__))))
    print("{}".format(args).replace(', ', ',\n'))

    # reproducibility (reference: main:154-157): numpy drives the host-side
    # data pipeline (and --roll's shift, which a data index's W shards
    # share); the weights and the drop-path draws come from explicit torch
    # generators
    seed = args.seed + mesh.data_index
    np.random.seed(seed)

    dataset_train = generate_dataset(is_train=True, args=args)
    dataset_val = generate_dataset(is_train=False, args=args)
    print(f"There are totally {len(dataset_train)} training data "
          f"and {len(dataset_val)} validation data")

    # Effective batch parity: torchrun scripts mean batch_size per worker x
    # nproc (reference: main:265); under sequence parallel per data index
    global_rank = dist.get_rank()
    global_batch = args.batch_size * mesh.dp

    wandb_mod = init_wandb(args) if global_rank == 0 else None
    if global_rank == 0 and args.log_dir is not None:
        os.makedirs(args.log_dir, exist_ok=True)
        log_writer = TBWriter(log_dir=args.log_dir)
    else:
        log_writer = None

    # each data index loads its own stride of the epoch, for train and val
    # (reference: DistributedSampler, main:172-178); in training each of its
    # seq ranks takes its W shard of the batch, in eval the whole scans
    sampler_train = ShardedSampler(len(dataset_train), num_replicas=mesh.dp,
                                   rank=mesh.data_index, shuffle=True,
                                   seed=args.seed, drop_last=True)
    data_loader_train = DataLoader(
        dataset_train, batch_size=args.batch_size, sampler=sampler_train,
        drop_last=True, num_workers=args.num_workers,
        w_shard=(mesh.seq_index, sp) if sp > 1 else None)
    data_loader_val = DataLoader(
        dataset_val, batch_size=1,
        sampler=ShardedSampler(len(dataset_val), num_replicas=mesh.dp,
                               rank=mesh.data_index, shuffle=False),
        drop_last=False, num_workers=args.num_workers)

    model.load_state_dict(
        init_params(cfg, torch.Generator().manual_seed(args.seed)),
        strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model = {args.model_select} ({n_params / 1e6:.1f}M params)")

    eval_dtype = (torch.float32 if args.eval_precision == 'fp32'
                  else torch.bfloat16)

    if args.eval and os.path.exists(args.output_dir):
        print("Loading Checkpoint and directly start the evaluation")
        if args.output_dir.endswith("pth"):
            args.resume = args.output_dir
            args.output_dir = os.path.dirname(args.output_dir)
        else:
            ckpt_util.get_latest_checkpoint(args)
        ckpt_util.load_model(args, model, None)
        model = model.to(device=device, dtype=eval_dtype)
        replicate(model)

        print("Start Evaluation")
        sp_forward = None
        if sp > 1:
            sp_forward = make_sp_eval_forward(
                model, mesh, mode="mc" if args.mc_drop else "eval",
                compute_dtype=eval_dtype)
        if args.mc_drop:
            print("Evaluation with Monte Carlo Dropout")
            MCdrop(data_loader_val, model, log_writer, args=args,
                   device=device, compute_dtype=eval_dtype,
                   sp_forward=sp_forward)
        else:
            evaluate(data_loader_val, model, log_writer, args=args,
                     device=device, compute_dtype=eval_dtype,
                     sp_forward=sp_forward)
        dist.barrier()   # the others wait while rank 0 finishes its metrics
        print("Evaluation finished")
        sys.exit(0)
    else:
        print("Start Training")

    eff_batch_size = global_batch * args.accum_iter
    if args.lr is None:  # only base_lr specified (reference: main:267-268)
        args.lr = args.blr * eff_batch_size / 256
    print("base lr: %.2e" % (args.lr * 256 / eff_batch_size))
    print("actual lr: %.2e" % args.lr)
    print("accumulate grad iterations: %d" % args.accum_iter)
    print("effective batch size: %d" % eff_batch_size)

    model = model.to(device)
    optimizer = make_optimizer(model, args.weight_decay)
    compute_dtype = (torch.bfloat16 if args.precision == 'bf16'
                     else torch.float32)
    if sp > 1:
        train_step = make_sp_train_step(model, optimizer, mesh,
                                        accum_iter=args.accum_iter,
                                        compute_dtype=compute_dtype)
    else:
        train_step = make_train_step(model, optimizer,
                                     accum_iter=args.accum_iter,
                                     compute_dtype=compute_dtype)

    args.start_epoch = ckpt_util.load_model(args, model, optimizer,
                                            train_step)
    replicate(model)

    print(f"Start training for {args.epochs} epochs")
    start_time = time.time()

    # Preemption handling (as the JAX package's entry): on SIGTERM finish
    # the current epoch, checkpoint, and exit cleanly so that --resume /
    # get_latest_checkpoint restarts it.  The flag is reduced over the
    # ranks at the end of each epoch, so that all of them stop together.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        print(f"[tulip_tpu_torch] received signal {signum}; will checkpoint "
              "and exit at the end of this epoch")
        preempted["flag"] = True

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread

    for epoch in range(args.start_epoch, args.epochs):
        sampler_train.set_epoch(epoch)
        train_stats = train_one_epoch(
            train_step, data_loader_train, epoch, device=device,
            log_writer=log_writer, args=args)
        if args.output_dir and (epoch % args.save_frequency == 0
                                or epoch + 1 == args.epochs):
            if dist.is_main_process():
                ckpt_util.save_model(args, epoch, model, optimizer,
                                     train_step)
            dist.barrier()

        log_stats = {**{f'train_{k}': v for k, v in train_stats.items()},
                     'epoch': epoch}
        if args.output_dir and dist.is_main_process():
            if log_writer is not None:
                log_writer.flush()
            with open(os.path.join(args.output_dir, "log.txt"), mode="a",
                      encoding="utf-8") as f:
                f.write(json.dumps(log_stats) + "\n")

        stop = dist.all_reduce_sum(
            np.asarray([float(preempted["flag"])]))[0] > 0
        if stop:
            if args.output_dir and dist.is_main_process():
                ckpt_util.save_model(args, epoch, model, optimizer,
                                     train_step)
                print(f"[tulip_tpu_torch] preemption checkpoint written at "
                      f"epoch {epoch}")
            dist.barrier()
            break

    total_time = time.time() - start_time
    total_time_str = str(datetime.timedelta(seconds=int(total_time)))
    print('Training time {}'.format(total_time_str))
    print('Training finished')

    if global_rank == 0:
        finish_wandb(wandb_mod)


def cli(argv=None):
    from tulip_tpu_torch.config import get_args_parser
    args = get_args_parser().parse_args(argv)
    if args.output_dir and not args.eval:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)


if __name__ == '__main__':
    cli()
