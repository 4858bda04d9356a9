"""LARS optimizer (Layer-wise Adaptive Rate Scaling; port of
tulip_tpu/utils/lars.py).

The reference ships util/lars.py (large-batch training, never imported at
runtime).  Here it is a ``torch.optim.Optimizer`` with the JAX package's
update: the weight decay added to the gradient, the trust ratio on
parameters with more than one dimension only, momentum over the scaled
gradient, and the step ``-lr * momentum``.
"""

from __future__ import annotations

import torch


class LARS(torch.optim.Optimizer):
    """For each parameter p with gradient g:

        g' = g + weight_decay * p
        local_lr = trust_coefficient * ||p|| / (||g'|| + eps) where p.ndim > 1
                   and both norms are positive, else 1
        m = momentum * m + local_lr * g'
        p = p - lr * m
    """

    def __init__(self, params, lr: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 eps: float = 1e-8):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, momentum=momentum,
            trust_coefficient=trust_coefficient, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + group["weight_decay"] * p
                if p.ndim > 1:
                    p_norm = torch.linalg.vector_norm(p)
                    g_norm = torch.linalg.vector_norm(g)
                    local_lr = torch.where(
                        (p_norm > 0) & (g_norm > 0),
                        group["trust_coefficient"] * p_norm
                        / (g_norm + group["eps"]), torch.ones_like(p_norm))
                    g = local_lr * g
                state = self.state[p]
                if "momentum" not in state:
                    state["momentum"] = torch.zeros_like(p)
                m = state["momentum"]
                m.mul_(group["momentum"]).add_(g)
                p.add_(m, alpha=-group["lr"])
        return loss
