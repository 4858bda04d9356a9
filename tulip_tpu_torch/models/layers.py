"""Primitive layers, parameter containers, initializers and attention
statics (port of tulip_tpu/models/layers.py).

Parameters are stored in the reference torch layouts, under the reference
state-dict names: Linear ``weight`` (out, in), Conv2d ``weight`` OIHW.
Activations are NHWC.  Matmuls run in the activation dtype; LayerNorm
statistics and GELU are computed in fp32.

The parameter containers allocate trainable tensors with ``torch.empty``
and draw nothing from any random generator: weights come from
:func:`tulip_tpu_torch.models.tulip.init_params` (explicit
``torch.Generator``) or from a checkpoint, through ``load_state_dict``.
Statistics that are fp32 for fp32 / bf16 inputs stay float64 for float64
inputs (:func:`wide`), so the plain versions can be checked against
autograd in float64.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + b, with w in torch (out, in) layout."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pointwise NHWC convolution with an OIHW (O, I, 1, 1) kernel."""
    return linear(x, w.reshape(w.shape[0], w.shape[1]), b)


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the accumulation dtype: fp32, or float64 for a float64 t."""
    return t if t.dtype == torch.float64 else t.float()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics."""
    x32 = wide(x)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * w.to(x32.dtype) + b.to(x32.dtype)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU evaluated in fp32."""
    return F.gelu(wide(x)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


class RankDraws(NamedTuple):
    """The drop-path and dropout draws of one rank of a dp x sp layout:
    each draw is the keep mask of the whole global tensor from
    ``generator``, which every rank seeds alike, and the rank keeps its
    part of it.  Along the batch that is data rank ``rank`` of ``world``
    (ranks of equal batch, joined in rank order); along W, under W-axis
    sequence parallel, seq shard ``seq`` of ``n_seq`` (equal W shards,
    joined in seq order).  So the ranks' generators stay in step and the
    ranks draw what one process draws on the joined batch and the whole
    scan.  (The JAX package keeps one key for the global batch, and under
    sequence parallel draws a local mask on each shard.)"""
    generator: torch.Generator
    rank: int
    world: int
    seq: int = 0
    n_seq: int = 1


Draws = Union[torch.Generator, RankDraws]


def _keep_mask(x: torch.Tensor, shape, keep: float, generator: Draws,
               grid: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The keep mask of x (``shape``, x's first axis first), drawn for the
    global tensor and cut to this rank's part.

    Without ``grid`` the mask has no W axis (drop-path's per-sample
    mask): the global batch is drawn and the rank's block of rows kept;
    x's first axis is batch-major at every site, so that block is
    contiguous.  With ``grid`` = (B, rows, cols), x's elements in order
    are (B, rows, cols, rest) with W along ``cols`` (tokens (B, H, W, C):
    (B, H, W); windows (B·nWh·nWw, ...): (B, nWh, nWw)); the mask is
    drawn as (B·world, rows, cols·n_seq, rest) and the rank's rows and
    W columns kept."""
    rank, world, seq, n_seq = 0, 1, 0, 1
    if isinstance(generator, RankDraws):
        generator, rank, world, seq, n_seq = generator
    if grid is None:
        if n_seq > 1 and math.prod(shape[1:]) > 1:
            raise ValueError(
                f"a mask of shape {tuple(shape)} drawn across {n_seq} W "
                "shards needs its site's grid")
        n = x.shape[0]
        u = torch.rand((n * world,) + tuple(shape[1:]), generator=generator,
                       device=x.device)
        return u[rank * n:(rank + 1) * n] < keep
    b, rows, cols = grid
    rest = x.numel() // (b * rows * cols)
    u = torch.rand((b * world, rows, cols * n_seq, rest),
                   generator=generator, device=x.device)
    u = u[rank * b:(rank + 1) * b, :, seq * cols:(seq + 1) * cols]
    return (u < keep).reshape(x.shape)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[Draws],
              active: bool) -> torch.Tensor:
    """Per-sample stochastic depth (reference: tulip/model/tulip.py:16-30;
    tulip_tpu/models/layers.py:drop_path): each sample of the batch is kept
    with probability 1 - rate and scaled by 1 / (1 - rate), or zeroed.  The
    draw comes from ``generator``, which lives on x's device: a
    ``torch.Generator`` where x is the whole batch, a :class:`RankDraws`
    where x is one rank's rows of it (the W shards of a data index draw
    alike)."""
    if not active or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x, (x.shape[0],) + (1,) * (x.ndim - 1), keep,
                      generator)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: Optional[Draws],
            active: bool,
            grid: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Element-wise dropout (tulip_tpu/models/layers.py:dropout): each
    element is kept with probability 1 - rate and scaled by 1 / (1 - rate),
    or zeroed.  Drawn as :func:`drop_path` draws, from the same
    ``generator`` (a :class:`RankDraws` draws the global tensor's mask).
    ``grid`` = (B, rows, cols) says where W lies in x (see
    :func:`_keep_mask`); a draw across W shards needs it."""
    if not active or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(x, x.shape, keep, generator, grid)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# ---------------------------------------------------------------------------
# Parameter containers (reference module names, torch layouts)
# ---------------------------------------------------------------------------

def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    def __init__(self, in_f: int, out_f: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.weight = _empty((out_f, in_f), device, dtype)
        self.bias = _empty((out_f,), device, dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """Container for an OIHW kernel; the model applies it as im2col or
    pointwise matmuls, never through ``F.conv2d``."""

    def __init__(self, in_c: int, out_c: int, kh: int, kw: int,
                 bias: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.weight = _empty((out_c, in_c, kh, kw), device, dtype)
        self.bias = _empty((out_c,), device, dtype) if bias else None


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty((dim,), device, dtype)
        self.bias = _empty((dim,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


# ---------------------------------------------------------------------------
# Initializers (torch defaults, on an explicit generator; torch layouts)
# ---------------------------------------------------------------------------

def trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """trunc_normal_(std=std) with the default absolute bounds (-2, 2)."""
    return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                 generator=generator)


def torch_conv_init(out_c: int, in_c: int, kh: int, kw: int, bias: bool,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Conv2d default init (kaiming_uniform a=sqrt(5)), OIHW."""
    bound = 1.0 / math.sqrt(in_c * kh * kw)
    out = {"weight": torch.empty(out_c, in_c, kh, kw).uniform_(
        -bound, bound, generator=generator)}
    if bias:
        out["bias"] = torch.empty(out_c).uniform_(-bound, bound,
                                                  generator=generator)
    return out


def torch_linear_trunc_init(in_f: int, out_f: int, bias: bool,
                            generator: torch.Generator
                            ) -> Dict[str, torch.Tensor]:
    """Linear init of TULIP.init_weights: trunc_normal(std=.02) weight,
    zero bias; weight (out, in)."""
    out = {"weight": trunc_normal((out_f, in_f), 0.02, generator)}
    if bias:
        out["bias"] = torch.zeros(out_f)
    return out


def layer_norm_init(dim: int) -> Dict[str, torch.Tensor]:
    return {"weight": torch.ones(dim), "bias": torch.zeros(dim)}


# ---------------------------------------------------------------------------
# Static attention geometry (numpy; copies of tulip_tpu/models/layers.py)
# ---------------------------------------------------------------------------

def relative_position_index(window) -> np.ndarray:
    """Pairwise relative-position index for a rectangular window.  Shape
    (L, L), values in [0, (2wh-1)(2ww-1))."""
    wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))                  # 2,wh,ww
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]            # 2,L,L
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def cpb_coords_table(window) -> np.ndarray:
    """Swin-v2's log-spaced relative coordinates, ((2wh-1)(2ww-1), 2) fp32:
    the input of the continuous position bias MLP (the numpy half of
    tulip_tpu/models/swin.py:_cpb_table)."""
    wh, ww = window
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1)
    table[..., 0] /= max(wh - 1, 1)
    table[..., 1] /= max(ww - 1, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def shift_attention_mask(grid, window, shift) -> np.ndarray:
    """Additive 0/-100 attention mask for shifted windows, (nW, L, L) fp32.

    Reproduces the reference construction exactly, including its python
    slices on the already-shifted image and the 0/-100 fill values."""
    H, W = grid
    wh, ww = window
    sh, sw = shift
    assert H % wh == 0 and W % ww == 0, "H or W is not divisible by window_size"
    img_mask = np.zeros((H, W), dtype=np.float32)
    h_slices = (slice(0, -wh), slice(-wh, -sh), slice(-sh, None))
    w_slices = (slice(0, -ww), slice(-ww, -sw), slice(-sw, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(H // wh, wh, W // ww, ww)
    m = m.transpose(0, 2, 1, 3).reshape(-1, wh * ww)           # nW, L
    attn_mask = m[:, None, :] - m[:, :, None]                  # nW, L, L
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)
