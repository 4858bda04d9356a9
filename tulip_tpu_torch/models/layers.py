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
from typing import Dict, Optional

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


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              active: bool) -> torch.Tensor:
    """Per-sample stochastic depth (reference: tulip/model/tulip.py:16-30;
    tulip_tpu/models/layers.py:drop_path): each sample of the batch is kept
    with probability 1 - rate and scaled by 1 / (1 - rate), or zeroed.  The
    draw comes from ``generator``, which lives on x's device."""
    if not active or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
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
