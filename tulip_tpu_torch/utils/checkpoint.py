"""Weight exchange with the JAX package (the layout rules of
tulip_tpu/utils/checkpoint.py:export_torch_state_dict, both ways).

JAX params are a flat dict under the same reference key names, in JAX
layouts: Linear (in, out), Conv2d HWIO.  The relative-position bias table
keeps its layout.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_NON_LINEAR_2D = ("relative_position_bias_table",)


def state_dict_from_jax(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX param dict (numpy arrays) -> torch state dict (CPU tensors)."""
    out = {}
    for k, v in params.items():
        arr = np.array(v, dtype=np.float32)   # a writable copy
        if k.endswith(".weight"):
            if arr.ndim == 4:                    # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2 and not any(t in k for t in _NON_LINEAR_2D):
                arr = arr.T                      # (in, out) -> (out, in)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def jax_params_from_state_dict(
        state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Torch state dict (or a dict of its gradients) -> JAX param dict of
    fp32 numpy arrays (copies: later in-place updates of the tensors do not
    show through): the inverse of :func:`state_dict_from_jax`."""
    out = {}
    for k, v in state.items():
        arr = v.detach().cpu().float().numpy()
        if k.endswith(".weight"):
            if arr.ndim == 4:                    # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2 and not any(t in k for t in _NON_LINEAR_2D):
                arr = arr.T                      # (out, in) -> (in, out)
        out[k] = np.array(arr, order="C")
    return out


def load_jax_params(model: nn.Module, params: Dict[str, np.ndarray]) -> None:
    """Load JAX params into ``model`` (strict: every key must match)."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
