"""Fixed Sobel edge-detection filters (port of tulip_tpu/utils/filter.py).

The reference ships util/filter.py (Horizontal / VerticalEdgeDetectionCNN,
star-imported by the model and the engine, never called).  Here they are
``F.conv2d`` with the fixed 3 x 3 kernels, padding 1, and two modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_H_KERNEL = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_V_KERNEL = tuple(zip(*_H_KERNEL))


def _edge_conv(x: torch.Tensor, kernel) -> torch.Tensor:
    """x (B, 1, H, W) -> the same shape: a 3 x 3 cross-correlation with the
    fixed kernel, zero padding 1."""
    w = torch.tensor(kernel, dtype=x.dtype, device=x.device)
    return F.conv2d(x, w.reshape(1, 1, 3, 3), padding=1)


def horizontal_edges(x: torch.Tensor) -> torch.Tensor:
    return _edge_conv(x, _H_KERNEL)


def vertical_edges(x: torch.Tensor) -> torch.Tensor:
    return _edge_conv(x, _V_KERNEL)


class HorizontalEdgeDetectionCNN(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return horizontal_edges(x)


class VerticalEdgeDetectionCNN(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vertical_edges(x)
