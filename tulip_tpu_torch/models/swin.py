"""Swin-v1 block (port of tulip_tpu/models/swin.py:swin_block_v1).

The block is x = x + attn(LN1(x)); x = x + MLP(LN2(x)).  Inference runs it
as two fused ops: the attention half through
:func:`tulip_tpu_torch.ops.window_msa.window_msa` (the shifted-window roll
is addressing inside it) and the MLP half through
:func:`tulip_tpu_torch.ops.mlp.fused_ln_mlp`.  Training follows the JAX
package's pallas branch (swin.py:609-667): LN1, the qkv linear, the
differentiable attention core (:func:`~tulip_tpu_torch.ops.attn_core.
attn_core`, shift as addressing), the proj linear, drop-path and the
residual; then the MLP half through
:func:`~tulip_tpu_torch.ops.mlp.two_matmul` without its residual, drop-path
and the residual.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import StageConfig
from ..ops.attn_core import attn_core
from ..ops.mlp import fused_ln_mlp, two_matmul
from ..ops.window_msa import window_msa
from . import layers as L


class BlockStatic(NamedTuple):
    """Static per-block geometry: everything attention needs besides params."""
    grid: tuple            # (H, W) token grid
    window: tuple          # effective partition window (wh, ww)
    shift: tuple           # (sh, sw); (0, 0) for unshifted blocks
    num_heads: int
    rel_index: np.ndarray  # (L, L) int, built from the config window
    mask: Optional[np.ndarray]  # (nW, L, L) additive mask or None
    drop_path: float


def make_block_static(stage: StageConfig, block_idx: int,
                      config_window) -> BlockStatic:
    """Resolve one block's static geometry.  ``rel_index`` always derives
    from the config window, as in the reference, even where the partition
    window fell back to (1, wh*ww)."""
    shifted = block_idx % 2 == 1
    shift = stage.shift if shifted else (0, 0)
    mask = (L.shift_attention_mask(stage.grid, stage.window, stage.shift)
            if shifted else None)
    return BlockStatic(grid=stage.grid, window=stage.window, shift=shift,
                       num_heads=stage.num_heads,
                       rel_index=L.relative_position_index(config_window),
                       mask=mask, drop_path=stage.drop_path[block_idx])


class WindowAttention(nn.Module):
    """Parameter container for reference ``attn.*`` keys plus the static
    relative-position index (non-persistent buffer)."""

    def __init__(self, dim: int, st: BlockStatic, config_window,
                 qkv_bias: bool, *, device=None, dtype=None):
        super().__init__()
        wh, ww = config_window
        self.qkv = L.Linear(dim, 3 * dim, qkv_bias, device=device, dtype=dtype)
        self.proj = L.Linear(dim, dim, True, device=device, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * wh - 1) * (2 * ww - 1), st.num_heads,
                        device=device, dtype=dtype))
        self.register_buffer("relative_position_index",
                             torch.as_tensor(st.rel_index, device=device),
                             persistent=False)

    def gathered_bias(self) -> torch.Tensor:
        """(nh, L, L) fp32 relative-position bias."""
        idx = self.relative_position_index
        Lw = idx.shape[0]
        b = self.relative_position_bias_table.float()[idx.reshape(-1)]
        return b.reshape(Lw, Lw, -1).permute(2, 0, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = L.Linear(dim, hidden, True, device=device, dtype=dtype)
        self.fc2 = L.Linear(hidden, dim, True, device=device, dtype=dtype)


class SwinBlockV1(nn.Module):
    """Pre-norm Swin block (reference: tulip/model/tulip.py:326-352).
    Dropout is the identity (the shipped rates are 0); drop-path is active
    in training only."""

    def __init__(self, dim: int, st: BlockStatic, config_window,
                 mlp_ratio: float, qkv_bias: bool, eps: float, *,
                 device=None, dtype=None):
        super().__init__()
        self.st = st
        self.eps = eps
        self.norm1 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        self.attn = WindowAttention(dim, st, config_window, qkv_bias,
                                    device=device, dtype=dtype)
        self.norm2 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device, dtype=dtype)
        mask = None if st.mask is None else torch.as_tensor(st.mask,
                                                            device=device)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            return self._forward_train(x, generator)
        d = x.dtype
        a = self.attn
        cast = lambda t: t.to(d)
        x = window_msa(
            x, cast(self.norm1.weight), cast(self.norm1.bias),
            cast(a.qkv.weight), cast(a.qkv.bias), cast(a.proj.weight),
            cast(a.proj.bias), a.gathered_bias(),
            None if self.attn_mask is None else self.attn_mask.float(),
            window=self.st.window, shift=self.st.shift, eps=self.eps)
        B, H, W, C = x.shape
        m = self.mlp
        y = fused_ln_mlp(
            x.reshape(-1, C), cast(self.norm2.weight), cast(self.norm2.bias),
            cast(m.fc1.weight), cast(m.fc1.bias), cast(m.fc2.weight),
            cast(m.fc2.bias), eps=self.eps)
        return y.reshape(B, H, W, C)

    def _forward_train(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        B, H, W, C = x.shape
        d, rate = x.dtype, self.st.drop_path
        a, m = self.attn, self.mlp
        mask = None if self.attn_mask is None else self.attn_mask.float()
        y = L.layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps)
        qkv = L.linear(y, a.qkv.weight, a.qkv.bias)
        y = attn_core(qkv, a.gathered_bias(), mask, window=self.st.window,
                      shift=self.st.shift)
        y = L.linear(y, a.proj.weight, a.proj.bias)
        x = x + L.drop_path(y, rate, generator, True)
        y = two_matmul(
            x.reshape(-1, C), self.norm2.weight.to(d), self.norm2.bias.to(d),
            m.fc1.weight.to(d), m.fc1.bias.to(d), m.fc2.weight.to(d),
            m.fc2.bias.to(d), act="gelu", residual=False, eps=self.eps)
        return x + L.drop_path(y.reshape(B, H, W, C), rate, generator, True)
