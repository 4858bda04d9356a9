"""Per-iteration warmup + half-cosine LR schedule.

Parity target: tulip/util/lr_sched.py:9-21 — linear warmup to args.lr over
warmup_epochs, then min_lr + (lr-min_lr)*0.5*(1+cos(pi*t)).  The reference
adjusts per *iteration* with fractional epoch = step/len(loader) + epoch
(engine_upsampling.py:70).

A copy of tulip_tpu/utils/lr_sched.py: that module is jax-free, but its
package's ``__init__`` imports jax.
"""

from __future__ import annotations

import math


def lr_at_epoch(epoch: float, lr: float, min_lr: float, warmup_epochs: float,
                epochs: float) -> float:
    if epoch < warmup_epochs:
        return lr * epoch / warmup_epochs
    return min_lr + (lr - min_lr) * 0.5 * (
        1.0 + math.cos(math.pi * (epoch - warmup_epochs) / (epochs - warmup_epochs)))


def adjust_learning_rate(epoch: float, args) -> float:
    """Functional equivalent of the reference's optimizer-mutating version;
    callers write the returned lr into the optimizer's param groups."""
    return lr_at_epoch(epoch, args.lr, args.min_lr, args.warmup_epochs, args.epochs)
