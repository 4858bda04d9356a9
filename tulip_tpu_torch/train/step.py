"""Train step: bf16 forward / backward over fp32 master weights, AdamW,
per-iteration LR, gradient accumulation (port of tulip_tpu/train/step.py).

The model's parameters stay fp32; with ``compute_dtype=torch.bfloat16``
the forward casts each weight where it uses it and autograd carries each
gradient back to the fp32 parameter.  bf16 has fp32's exponent range, so
there is no loss scaling (no GradScaler), as on the TPU.

Optimizer parity with the JAX package: AdamW(betas=(0.9, 0.95),
eps=1e-8), weight decay only on parameters with ndim > 1 (linear and conv
weights and the relative-position bias tables), the effective behaviour of
timm's param_groups_layer_decay in the reference
(main_lidar_upsampling.py:282-283).

Data parallel: under a torch.distributed group each rank runs the step on
its own rows of the global batch, and after every micro-step's backward
the ``.grad``s are averaged across the ranks (``dist.average_``, a few flat
buckets; in a group of one rank, too, as DDP would), as the JAX package's
psum inside its step: N ranks of batch B compute the step of one process
on the N·B samples joined in rank order, up to summation order, and every
rank holds the same gradient buffer and moves the same weights.
"""

from __future__ import annotations

import torch

from ..models.tulip import TULIP, apply_model
from ..parallel import dist


def make_optimizer(model: TULIP, weight_decay: float) -> torch.optim.AdamW:
    """AdamW over two param groups, decayed (ndim > 1) and not; the LR is
    written per step by the train step, which also does the accumulation
    that optax.MultiSteps does inside the JAX package's optimizer."""
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": [p for p in params if p.ndim > 1],
               "weight_decay": weight_decay},
              {"params": [p for p in params if p.ndim <= 1],
               "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.95), eps=1e-8)


def make_train_step(model: TULIP, opt: torch.optim.Optimizer, *,
                    accum_iter: int = 1, compute_dtype=torch.bfloat16,
                    forward=None):
    """Build ``step(low, high, lr, generator) -> (total_loss, pixel_loss)``.

    low / high: NCHW fp32 tensors on the model's device (under data
    parallel this rank's rows of the global batch); lr: this step's
    learning rate; generator: the drop-path and dropout draws (on the device; a
    ``layers.RankDraws`` under data parallel).  With
    ``accum_iter`` k > 1 the gradient is the mean over k micro-steps and
    the weights move on the k-th only (optax.MultiSteps semantics).  The
    returned losses are device scalars, not yet read back; under a group,
    their means over the ranks, so that every rank reads the same.

    ``forward(low, high, generator) -> (pred, total_loss, pixel_loss)``
    replaces ``apply_model(mode="train")``: W-axis sequence parallel's
    sharded forward (``parallel/sp.py:make_sp_train_step``), whose losses
    are this rank's shard's and whose world mean is the global loss.

    ``step.state_dict()`` / ``step.load_state_dict(d)`` carry the
    accumulation across a checkpoint: the micro-step counter and the
    gradient buffer (the parameters' ``.grad``, which holds the sum so far
    of the micro-steps' gradients over k).  With ``accum_iter`` 1 there is
    nothing to carry and ``state_dict()`` is None.

    Under a group the whole ``.grad`` buffer is averaged after each
    micro-step, so it is the same on every rank and the checkpoint's
    'accum' entry resumes exactly.  The buckets are flattened anew at each
    reduction (a copy in and out, 2 x 108.6 MB for TULIP-base's fp32
    gradients): ``zero_grad(set_to_none=True)`` and ``load_state_dict``
    replace the ``.grad`` tensors, and persistent views into one flat
    buffer would have to survive both."""
    micro = 0
    params = [p for p in model.parameters() if p.requires_grad]
    if forward is None:
        def forward(low, high, generator):
            return apply_model(model, low, high, mode="train",
                               generator=generator,
                               compute_dtype=compute_dtype)

    def step(low, high, lr, generator=None):
        nonlocal micro
        for group in opt.param_groups:
            group["lr"] = float(lr)
        _, total_loss, pixel_loss = forward(low, high, generator)
        (total_loss / accum_iter).backward()
        total_loss, pixel_loss = total_loss.detach(), pixel_loss.detach()
        if dist.in_group():
            losses = torch.stack([total_loss, pixel_loss])
            dist.average_([p.grad for p in params if p.grad is not None]
                          + [losses])
            total_loss, pixel_loss = losses[0], losses[1]
        micro += 1
        if micro % accum_iter == 0:
            opt.step()
            opt.zero_grad(set_to_none=True)
        return total_loss, pixel_loss

    def state_dict():
        if accum_iter == 1:
            return None
        return {"micro": micro % accum_iter,
                "grads": {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()
                          if p.grad is not None}}

    def load_state_dict(state):
        """``state``: a :func:`state_dict`, or {'micro', 'mean_grads'} with
        the mean of the micro-steps' gradients so far (what
        optax.MultiSteps keeps), or None."""
        nonlocal micro
        opt.zero_grad(set_to_none=True)
        micro = 0
        if state is None or accum_iter == 1:
            return
        micro = int(state["micro"]) % accum_iter
        if micro == 0:
            return
        grads, scale = state.get("grads"), 1.0
        if grads is None:
            grads, scale = state["mean_grads"], micro / accum_iter
        for n, p in model.named_parameters():
            if n in grads:
                p.grad = (grads[n].to(device=p.device, dtype=p.dtype)
                          * scale)

    step.state_dict = state_dict
    step.load_state_dict = load_state_dict
    return step
