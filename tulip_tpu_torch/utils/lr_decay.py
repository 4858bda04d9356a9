"""Layer-wise learning-rate decay (BEiT-style; port of
tulip_tpu/utils/lr_decay.py).

The reference ships util/lr_decay.py (never imported at runtime).  Each
parameter gets a layer id from its state-dict name and its learning rate
is scaled by ``layer_decay ** (num_layers - layer_id)``;
:func:`param_groups` turns the scales into optimizer parameter groups, the
counterpart of the JAX package's ``scale_by_lr_tree`` transformation.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch


def get_layer_id(name: str, num_layers: int) -> int:
    """Map a parameter name to a depth index: patch embed -> 0, encoder
    stage i -> i + 1, everything else (decoder / head) -> num_layers."""
    if name.startswith("patch_embed"):
        return 0
    if name.startswith("layers."):
        return int(name.split(".")[1]) + 1
    return num_layers


def lr_scale_tree(params: Iterable[str], num_layers: int,
                  layer_decay: float = 0.75) -> Dict[str, float]:
    """Per-parameter LR multipliers, keyed by name (``params``: names, or
    a dict keyed by them)."""
    return {k: layer_decay ** (num_layers - get_layer_id(k, num_layers))
            for k in params}


def param_groups(named_params: Iterable[Tuple[str, torch.Tensor]],
                 num_layers: int, lr: float,
                 layer_decay: float = 0.75) -> List[dict]:
    """Optimizer parameter groups, one per distinct scale in order of first
    appearance: ``lr`` is the base lr times the scale, ``lr_scale`` the
    scale (timm's key, for schedules that rescale each group) and
    ``names`` the members' names."""
    named = list(named_params)
    scales = lr_scale_tree([n for n, _ in named], num_layers, layer_decay)
    groups: Dict[float, dict] = {}
    for name, p in named:
        s = scales[name]
        grp = groups.setdefault(s, dict(params=[], names=[], lr=lr * s,
                                        lr_scale=s))
        grp["params"].append(p)
        grp["names"].append(name)
    return list(groups.values())
