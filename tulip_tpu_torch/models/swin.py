"""Swin-v1 and Swin-v2 blocks (port of tulip_tpu/models/swin.py:
swin_block_v1, swin_block_v2).

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

With dropout active (modes 'train' and 'mc') at a non-zero ``drop_rate``
or ``attn_drop_rate`` the v1 block leaves the kernels where the JAX
package leaves its own: the attention half becomes the plain composition
of window_attention_v1 with its two dropout sites, and the MLP half too
where ``drop_rate`` > 0 (:meth:`SwinBlockV1._forward_dropout`).

The v2 block (:class:`SwinBlockV2`) is post-norm with cosine attention
and a continuous position bias; its attention is PyTorch ops (the JAX
package has no kernel for it either), its MLP and its two norms run on
the two-matmul and LayerNorm kernels.

Three environment switches of the JAX package are read with their meaning
there (default off):

- ``TULIP_TPU_LN_PALLAS=1``: bf16 training takes norm1 through the
  LayerNorm kernels (:func:`~tulip_tpu_torch.ops.ln.layer_norm_fn`), as
  swin.py:610-625 takes ``layer_norm_vjp``.
- ``TULIP_TPU_MSA_GROUPED=1``: inference sends every block's attention
  half through the grouped window-major layout (roll, partition,
  :func:`~tulip_tpu_torch.ops.window_msa.window_msa_grouped`, un-partition,
  roll back), as swin.py:467-522.
- ``TULIP_TPU_MSA_NAT=1``: inference sends the blocks with more heads than
  the cutover (8, or ``TULIP_TPU_MSA_MASKED``) through the natural
  row-strip entry (roll, :func:`~tulip_tpu_torch.ops.window_msa.
  window_msa_nat`, roll back); the others keep the default path.  It wins
  over ``TULIP_TPU_MSA_GROUPED``, as there.

Under W-axis sequence parallel (``parallel/sp.py``) x is this rank's W
shard: a shifted block rolls it by -sw across the shards
(``halo.roll_w``, an exchange of sw columns), hands the kernel the shift
(sh, 0) and the shard's mask (``halo.block_mask``), and rolls the result
back by +sw.  In training the roll takes LN1(x), C wide, not qkv, 3C wide
(LN1 and the linear are token-wise, so the orders agree), and the attention
core's output, before proj.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import StageConfig
from ..ops.attn_core import attn_core
from ..ops.ln import layer_norm_fn
from ..ops.mlp import fused_ln_mlp, two_matmul
from ..ops.window_msa import (group_partition, group_unpartition, window_msa,
                              window_msa_grouped, window_msa_nat)
from ..parallel.halo import block_mask, roll_hw, roll_w, sharded
from . import layers as L

GROUP_TARGET = 8   # windows per group of the grouped layout (128 tokens)
CPB_HIDDEN = 512   # width of Swin-v2's position-bias MLP


def _use_masked(nh: int) -> bool:
    """The JAX package's head-count cutover between its two attention
    cores (window_msa.py:880-889): heads <= 8, or <= TULIP_TPU_MSA_MASKED."""
    raw = os.environ.get("TULIP_TPU_MSA_MASKED", "")
    return nh <= (8 if raw == "" else int(raw))


def msa_layout(nh: int) -> str:
    """Which attention entry inference takes for a block of ``nh`` heads:
    'default', 'grouped' or 'nat' (the dispatch of swin.py:496-522)."""
    if os.environ.get("TULIP_TPU_MSA_NAT") == "1":
        return "default" if _use_masked(nh) else "nat"
    if os.environ.get("TULIP_TPU_MSA_GROUPED") == "1":
        return "grouped"
    return "default"


class BlockStatic(NamedTuple):
    """Static per-block geometry: everything attention needs besides params."""
    grid: tuple            # (H, W) token grid
    window: tuple          # effective partition window (wh, ww)
    shift: tuple           # (sh, sw); (0, 0) for unshifted blocks
    num_heads: int
    rel_index: np.ndarray  # (L, L) int, from the window make_block_static gets
    mask: Optional[np.ndarray]  # (nW, L, L) additive mask or None
    drop_path: float


def make_block_static(stage: StageConfig, block_idx: int,
                      config_window) -> BlockStatic:
    """Resolve one block's static geometry.  ``rel_index`` derives from
    ``config_window``: for v1 the config window, as in the reference, even
    where the partition window fell back to (1, wh*ww); for v2 the
    stage's own window."""
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
    relative-position index (non-persistent buffer).  Without ``qkv_bias``
    there is no ``qkv.bias``; the attention kernels then get a zero bias,
    as the JAX package gives its own (swin.py:311-313, :477-478)."""

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
        """(nh, L, L) fp32 relative-position bias (float64 for a float64
        table, so that a float64 run rounds nothing to fp32)."""
        idx = self.relative_position_index
        Lw = idx.shape[0]
        b = L.wide(self.relative_position_bias_table)[idx.reshape(-1)]
        return b.reshape(Lw, Lw, -1).permute(2, 0, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = L.Linear(dim, hidden, True, device=device, dtype=dtype)
        self.fc2 = L.Linear(hidden, dim, True, device=device, dtype=dtype)


def layer_norm_tokens(norm: L.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` over the last axis of x, through the LayerNorm kernels
    (K14, and K15 in its backward)."""
    C = x.shape[-1]
    return layer_norm_fn(x.reshape(-1, C).contiguous(), norm.weight,
                         norm.bias, norm.eps).reshape(x.shape)


def window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, wh*ww, C), windows ordered (b, nh, nw)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // wh) * (W // ww), wh * ww, C)


def window_reverse(x: torch.Tensor, wh: int, ww: int, H: int,
                   W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    nH, nW = H // wh, W // ww
    B = x.shape[0] // (nH * nW)
    x = x.reshape(B, nH, nW, wh, ww, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def _add_mask(attn: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """attn (Bn, nh, L, L) + the (nW, L, L) mask of each sample's windows."""
    if mask is None:
        return attn
    nW, Lw = mask.shape[0], mask.shape[-1]
    Bn, nh = attn.shape[:2]
    attn = attn.reshape(Bn // nW, nW, nh, Lw, Lw) + mask[None, :, None]
    return attn.reshape(Bn, nh, Lw, Lw)


def _window_attention_dropout(a: WindowAttention, y: torch.Tensor,
                              st: BlockStatic, mask, attn_drop: float,
                              proj_drop: float, generator) -> torch.Tensor:
    """v1 shifted-window MSA with attention and projection dropout, the
    composition of tulip_tpu/models/swin.py:window_attention_v1: y is LN1's
    output (B, H, W, C); the logits and the softmax are fp32, the softmax
    output is cast to y's dtype before its dropout (rate ``attn_drop``),
    and proj's output gets ``proj_drop``.  Both draw per window, in the
    window-major layout."""
    B, H, W, C = y.shape
    (wh, ww), (sh, sw) = st.window, st.shift
    nh = st.num_heads
    hd, Lw = C // nh, wh * ww
    y = roll_hw(y, -sh, -sw)
    xw = window_partition(y, wh, ww)
    Bn = xw.shape[0]
    qkv = L.linear(xw, a.qkv.weight, a.qkv.bias)
    qkv = qkv.reshape(Bn, Lw, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = L.wide(q * hd ** -0.5) @ L.wide(k).transpose(-1, -2)
    attn = _add_mask(attn + a.gathered_bias()[None], mask)
    attn = torch.softmax(attn, dim=-1).to(y.dtype)
    attn = L.dropout(attn, attn_drop, generator, True)
    out = (attn @ v).transpose(1, 2).reshape(Bn, Lw, C)
    out = L.linear(out, a.proj.weight, a.proj.bias)
    out = L.dropout(out, proj_drop, generator, True)
    return roll_hw(window_reverse(out, wh, ww, H, W), sh, sw)


def _mlp_dropout(m: Mlp, y: torch.Tensor, drop: float,
                 generator) -> torch.Tensor:
    """fc1 -> GELU -> dropout -> fc2 -> dropout (tulip_tpu/models/swin.py:
    mlp), both at rate ``drop``."""
    h = L.gelu(L.linear(y, m.fc1.weight, m.fc1.bias))
    h = L.dropout(h, drop, generator, True)
    return L.dropout(L.linear(h, m.fc2.weight, m.fc2.bias), drop, generator,
                     True)


class SwinBlockV1(nn.Module):
    """Pre-norm Swin block (reference: tulip/model/tulip.py:326-352).
    Drop-path is active in training only; dropout (rates ``drop`` and
    ``attn_drop``) where ``dropout`` is set, in training and MC dropout."""

    def __init__(self, dim: int, st: BlockStatic, config_window,
                 mlp_ratio: float, qkv_bias: bool, eps: float, *,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 device=None, dtype=None):
        super().__init__()
        self.st = st
        self.eps = eps
        self.drop, self.attn_drop = drop, attn_drop
        self.norm1 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        self.attn = WindowAttention(dim, st, config_window, qkv_bias,
                                    device=device, dtype=dtype)
        self.norm2 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device, dtype=dtype)
        mask = None if st.mask is None else torch.as_tensor(st.mask,
                                                            device=device)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout: bool = False,
                generator: Optional[L.Draws] = None) -> torch.Tensor:
        """``train``: drop-path active (and autograd); ``dropout``: the
        dropout sites active.  Both draw from ``generator``."""
        if dropout and (self.drop > 0.0 or self.attn_drop > 0.0):
            return self._forward_dropout(x, train, generator)
        if train:
            return self._forward_train(x, generator)
        d = x.dtype
        cast = lambda t: t.to(d)
        x = self._attention_half(x, cast)
        B, H, W, C = x.shape
        m = self.mlp
        y = fused_ln_mlp(
            x.reshape(-1, C), cast(self.norm2.weight), cast(self.norm2.bias),
            cast(m.fc1.weight), cast(m.fc1.bias), cast(m.fc2.weight),
            cast(m.fc2.bias), eps=self.eps)
        return y.reshape(B, H, W, C)

    def _attention_half(self, x: torch.Tensor, cast) -> torch.Tensor:
        """x + proj(MSA(LN1(x))) through the entry :func:`msa_layout`
        names; the three compute the same function."""
        a, st = self.attn, self.st
        mask = block_mask(self, self.attn_mask)
        bqkv = (a.qkv.weight.new_zeros(a.qkv.weight.shape[0])
                if a.qkv.bias is None else a.qkv.bias)
        args = (cast(self.norm1.weight), cast(self.norm1.bias),
                cast(a.qkv.weight), cast(bqkv), cast(a.proj.weight),
                cast(a.proj.bias), a.gathered_bias(),
                None if mask is None else mask.float())
        layout = msa_layout(st.num_heads)
        (wh, ww), (sh, sw) = st.window, st.shift
        if layout == "default":
            if not sharded():
                return window_msa(x, *args, window=st.window, shift=st.shift,
                                  eps=self.eps)
            out = window_msa(roll_w(x, -sw), *args, window=st.window,
                             shift=(sh, 0), eps=self.eps)
            return roll_w(out, sw)
        B, H, W, C = x.shape
        xr = roll_hw(x, -sh, -sw)
        if layout == "nat":
            out = window_msa_nat(xr.reshape(B * (H // wh), wh, W, C), *args,
                                 nH=H // wh, eps=self.eps).reshape(B, H, W, C)
        else:
            group = min(GROUP_TARGET, W // ww)
            while (W // ww) % group:
                group -= 1
            xg = group_partition(xr, st.window, group)
            out = group_unpartition(
                window_msa_grouped(xg, *args, eps=self.eps), (H, W),
                st.window, group)
        return roll_hw(out, sh, sw)

    def _norm1(self, x: torch.Tensor) -> torch.Tensor:
        if (x.dtype == torch.bfloat16
                and os.environ.get("TULIP_TPU_LN_PALLAS") == "1"):
            return layer_norm_tokens(self.norm1, x)
        return L.layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps)

    def _mlp_half(self, x: torch.Tensor) -> torch.Tensor:
        """fc2(gelu(fc1(LN2(x)))) through the differentiable two-matmul
        (K3 / K10), without its residual."""
        B, H, W, C = x.shape
        d, m = x.dtype, self.mlp
        y = two_matmul(
            x.reshape(-1, C), self.norm2.weight.to(d), self.norm2.bias.to(d),
            m.fc1.weight.to(d), m.fc1.bias.to(d), m.fc2.weight.to(d),
            m.fc2.bias.to(d), act="gelu", residual=False, eps=self.eps)
        return y.reshape(B, H, W, C)

    def _forward_train(self, x: torch.Tensor,
                       generator: Optional[L.Draws]) -> torch.Tensor:
        rate = self.st.drop_path
        a = self.attn
        mask = block_mask(self, self.attn_mask)
        mask = None if mask is None else mask.float()
        y = self._norm1(x)
        (sh, sw), w_sharded = self.st.shift, sharded()
        if w_sharded:
            y = roll_w(y, -sw)
        qkv = L.linear(y, a.qkv.weight, a.qkv.bias)
        y = attn_core(qkv, a.gathered_bias(), mask, window=self.st.window,
                      shift=(sh, 0) if w_sharded else (sh, sw))
        if w_sharded:
            y = roll_w(y, sw)
        y = L.linear(y, a.proj.weight, a.proj.bias)
        x = x + L.drop_path(y, rate, generator, True)
        return x + L.drop_path(self._mlp_half(x), rate, generator, True)

    def _forward_dropout(self, x: torch.Tensor, train: bool,
                         generator: Optional[L.Draws]) -> torch.Tensor:
        """The block with its dropout sites active, where the JAX package
        leaves its kernels (swin.py:365-368, :597-600, :638-639): the
        attention half as the plain composition; the MLP half too where
        ``drop`` > 0, else on the two-matmul kernel."""
        rate = self.st.drop_path
        mask = block_mask(self, self.attn_mask)
        y = _window_attention_dropout(
            self.attn, self._norm1(x), self.st,
            None if mask is None else mask.float(), self.attn_drop,
            self.drop, generator)
        x = x + L.drop_path(y, rate, generator, train)
        if self.drop > 0.0:
            y = _mlp_dropout(self.mlp, L.layer_norm(
                x, self.norm2.weight, self.norm2.bias, self.eps), self.drop,
                generator)
        else:
            y = self._mlp_half(x)
        return x + L.drop_path(y, rate, generator, train)


# ---------------------------------------------------------------------------
# Swin-v2 (cosine attention, post-norm; tulip_tpu/models/swin.py:676-768)
# ---------------------------------------------------------------------------

LOGIT_SCALE_MAX = math.log(1.0 / 0.01)


class WindowAttentionV2(nn.Module):
    """Parameter container for the reference's v2 ``attn.*`` keys (a
    bias-free qkv weight, q / v biases unless ``qkv_bias`` is False, the
    per-head logit scale, the continuous-position-bias MLP ``cpb_mlp.0`` /
    ``cpb_mlp.2``, proj), the static relative index and log-spaced
    coordinates of the stage's window (non-persistent buffers), and the
    cosine attention itself."""

    def __init__(self, dim: int, st: BlockStatic, qkv_bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        nh = st.num_heads
        self.qkv = L.Linear(dim, 3 * dim, False, device=device, dtype=dtype)
        self.q_bias = L._empty((dim,), device, dtype) if qkv_bias else None
        self.v_bias = L._empty((dim,), device, dtype) if qkv_bias else None
        self.logit_scale = L._empty((nh, 1, 1), device, dtype)
        self.cpb_mlp = nn.ModuleDict({
            "0": L.Linear(2, CPB_HIDDEN, True, device=device, dtype=dtype),
            "2": L.Linear(CPB_HIDDEN, nh, False, device=device,
                          dtype=dtype)})
        self.proj = L.Linear(dim, dim, True, device=device, dtype=dtype)
        self.register_buffer("relative_position_index",
                             torch.as_tensor(st.rel_index, device=device),
                             persistent=False)
        self.register_buffer(
            "relative_coords_table",
            torch.as_tensor(L.cpb_coords_table(st.window), device=device),
            persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(nh, L, L) 16·sigmoid of the CPB MLP's table, gathered by the
        relative index; fp32 (float64 for float64 weights)."""
        t = self.relative_coords_table
        w0, b0 = self.cpb_mlp["0"].weight, self.cpb_mlp["0"].bias
        t = t.to(L.wide(w0).dtype)
        # max(h, 0) as the JAX package writes it: a tie (the centre
        # coordinate against a zero bias) passes half the gradient, where
        # relu would pass none
        h = F.linear(t, L.wide(w0), L.wide(b0))
        h = torch.maximum(h, h.new_zeros(()))
        table = F.linear(h, L.wide(self.cpb_mlp["2"].weight))
        idx = self.relative_position_index
        Lw = idx.shape[0]
        bias = table[idx.reshape(-1)].reshape(Lw, Lw, -1).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias)

    def forward(self, xw: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Cosine attention over windows (Bn, L, C) -> (Bn, L, C): norms in
        fp32 clamped at 1e-12, fp32 logits times exp(min(logit_scale,
        log 100)), plus the position bias and the mask, fp32 softmax."""
        Bn, Lw, C = xw.shape
        nh = self.logit_scale.shape[0]
        hd, d = C // nh, xw.dtype
        bias = (None if self.q_bias is None else torch.cat(
            [self.q_bias, torch.zeros_like(self.v_bias), self.v_bias]))
        qkv = L.linear(xw, self.qkv.weight, bias)
        qkv = qkv.reshape(Bn, Lw, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]

        def unit(t):
            n = torch.linalg.vector_norm(L.wide(t), dim=-1, keepdim=True)
            return t / n.clamp_min(1e-12).to(d)

        attn = L.wide(unit(q)) @ L.wide(unit(k)).transpose(-1, -2)
        scale = torch.exp(L.wide(self.logit_scale).clamp_max(LOGIT_SCALE_MAX))
        attn = attn * scale[None] + self.position_bias()[None]
        attn = torch.softmax(_add_mask(attn, mask), dim=-1).to(d)
        out = (attn @ v).transpose(1, 2).reshape(Bn, Lw, C)
        return L.linear(out, self.proj.weight, self.proj.bias)


class SwinBlockV2(nn.Module):
    """Post-norm Swin-v2 block (reference: swin_transformer_v2.py:272-311;
    tulip_tpu/models/swin.py:swin_block_v2): x + drop_path(norm1(attn(x))),
    then x + drop_path(norm2(mlp(x))).  No dropout inside, as there.  The
    cosine attention is PyTorch ops; the MLP runs on the two-matmul
    kernels (K3 / K10, no LayerNorm prologue, no residual) and both norms
    on the LayerNorm kernels (K14 / K15)."""

    def __init__(self, dim: int, st: BlockStatic, mlp_ratio: float,
                 eps: float, qkv_bias: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        self.st = st
        self.eps = eps
        self.attn = WindowAttentionV2(dim, st, qkv_bias, device=device,
                                      dtype=dtype)
        self.norm1 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device=device, dtype=dtype)
        self.norm2 = L.LayerNorm(dim, eps, device=device, dtype=dtype)
        mask = None if st.mask is None else torch.as_tensor(st.mask,
                                                            device=device)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout: bool = False,
                generator: Optional[L.Draws] = None) -> torch.Tensor:
        """As :meth:`SwinBlockV1.forward`; ``dropout`` changes nothing."""
        B, H, W, C = x.shape
        (wh, ww), (sh, sw) = self.st.window, self.st.shift
        rate, d, m = self.st.drop_path, x.dtype, self.mlp
        mask = block_mask(self, self.attn_mask)
        y = window_partition(roll_hw(x, -sh, -sw), wh, ww)
        y = self.attn(y, None if mask is None else mask.float())
        y = roll_hw(window_reverse(y, wh, ww, H, W), sh, sw)
        y = layer_norm_tokens(self.norm1, y)
        x = x + L.drop_path(y, rate, generator, train)
        y = two_matmul(
            x.reshape(-1, C), None, None, m.fc1.weight.to(d),
            m.fc1.bias.to(d), m.fc2.weight.to(d), m.fc2.bias.to(d),
            act="gelu", residual=False, eps=self.eps)
        y = layer_norm_tokens(self.norm2, y.reshape(B, H, W, C))
        return x + L.drop_path(y, rate, generator, train)
