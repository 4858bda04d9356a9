"""Grid rolls and circular padding on (B, H, W, C) tensors
(single-device forms of tulip_tpu/parallel/halo.py:84-105)."""

from __future__ import annotations

import torch


def roll_hw(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """Roll a (B, H, W, C) grid by (sh, sw)."""
    if sh or sw:
        return torch.roll(x, shifts=(sh, sw), dims=(1, 2))
    return x


def circular_pad_w(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Cyclically pad the W axis of (B, H, W, C) by (left, right) columns
    (the patch-embed circular padding)."""
    W = x.shape[2]
    return torch.cat([x[:, :, W - left:], x, x[:, :, :right]], dim=2)
