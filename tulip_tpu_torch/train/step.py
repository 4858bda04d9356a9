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
"""

from __future__ import annotations

import torch

from ..models.tulip import TULIP, apply_model


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
                    accum_iter: int = 1, compute_dtype=torch.bfloat16):
    """Build ``step(low, high, lr, generator) -> (total_loss, pixel_loss)``.

    low / high: NCHW fp32 tensors on the model's device; lr: this step's
    learning rate; generator: the drop-path draws (on the device).  With
    ``accum_iter`` k > 1 the gradient is the mean over k micro-steps and
    the weights move on the k-th only (optax.MultiSteps semantics).  The
    returned losses are device scalars, not yet read back."""
    micro = 0

    def step(low, high, lr, generator=None):
        nonlocal micro
        for group in opt.param_groups:
            group["lr"] = float(lr)
        _, total_loss, pixel_loss = apply_model(
            model, low, high, mode="train", generator=generator,
            compute_dtype=compute_dtype)
        (total_loss / accum_iter).backward()
        micro += 1
        if micro % accum_iter == 0:
            opt.step()
            opt.zero_grad(set_to_none=True)
        return total_loss.detach(), pixel_loss.detach()

    return step
