"""TULIP Swin U-Net forward (port of tulip_tpu/models/tulip.py).

Architecture (base, DurLAR config): (B,1,32,2048) -> circular patch embed
(1,4) -> token grid 32x512x96 -> 4 encoder stages with patch merging ->
4x64x768 -> patch unmerging -> 3 decoder stages with concat + linear skip
fuse -> 32x512x96 -> norm_up + pixel-shuffle head (x4) + 1x1 prediction
conv, folded into one fused two-matmul -> (B,in_chans,128,2048).

Parameter names are the reference state-dict keys, in torch layouts, so
``load_state_dict(strict=True)`` takes a reference checkpoint or the JAX
package's weights (``tulip_tpu_torch.utils.checkpoint``).  Activations are
NHWC inside the model; :func:`apply_model` takes and returns NCHW.

``apply_model(mode="train")`` runs with autograd on: drop-path is active,
the attention core, the MLP halves, the merges and the head are
``torch.autograd.Function``s over the CUDA kernels (forward and backward);
the patch-embed im2col, the skip-fuse linears, the unmerging 1x1 convs and
the loss are plain autograd.

Every variant of the JAX package's ``model_config`` runs: Swin-v1 or
Swin-v2 blocks (``swin_v2``; PatchMergingV2 with them), the patch
unmerging or PatchExpanding decoder upsample (``patch_unmerging``), the
pixel-shuffle or FinalPatchExpanding head (``pixel_shuffle``), and
dropout at the config's ``drop_rate`` / ``attn_drop_rate`` in the modes
'train' and 'mc' (:func:`apply_model`).  The new norms (v2's post-norms,
PatchMergingV2's, PatchExpanding's, FinalPatchExpanding's and ``norm_up``
before it) run on the LayerNorm kernels.  ``in_chans`` channels in and
out: the patch embed's im2col takes them, and the folded head predicts
them (K3 with 16 x in_chans outputs at upscale 4).  ``qkv_bias=False``
(set with ``dataclasses.replace`` on the config) drops ``qkv.bias`` (v1)
or ``q_bias`` / ``v_bias`` (v2); the attention kernels then take a zero
bias, as the JAX package's do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig, model_config
from ..ops.mlp import ln_linear, two_matmul
from ..parallel.halo import circular_pad_w
from . import layers as L
from .swin import (CPB_HIDDEN, SwinBlockV1, SwinBlockV2, layer_norm_tokens,
                   make_block_static)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), zero-padded to even H and W;
    channel blocks (0,0),(1,0),(0,1),(1,1) (reference: tulip.py:92-99)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = x.shape[1], x.shape[2]
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def _depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, s*s*C) -> (B, H*s, W*s, C), channels split (p1, p2, c):
    the rearrange of PatchExpanding / FinalPatchExpanding."""
    B, H, W, CS = x.shape
    C = CS // (s * s)
    x = x.reshape(B, H, W, s, s, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H * s, W * s, C)


def _pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch.nn.PixelShuffle in NHWC: channel c*r*r + i*r + j maps to
    output (h*r+i, w*r+j, c)."""
    B, H, W, CR2 = x.shape
    C = CR2 // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)


class PatchEmbed(nn.Module):
    """(B, H, W, Cin) -> (B, H/ph, W/pw, C): circular pad (2, 2) and a
    (ph, 8) kernel at stride (ph, pw), as im2col + one matmul."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = 8 if cfg.circular_padding else cfg.patch_size[1]
        self.proj = L.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size[0],
                             kw, True, device=device, dtype=dtype)
        self.norm = (L.LayerNorm(cfg.embed_dim, cfg.layer_norm_eps,
                                 device=device, dtype=dtype)
                     if cfg.patch_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.cfg.patch_size
        B, H, W, Cin = x.shape
        if H % ph or W % pw:
            raise ValueError(f"input {H}x{W} not divisible by patch "
                             f"{self.cfg.patch_size}")
        if self.cfg.circular_padding:
            x = circular_pad_w(x, 2, 2)
        kw = self.proj.weight.shape[3]
        taps = x.unfold(2, kw, pw)                      # B, H, Wo, Cin, kw
        Wo = taps.shape[2]
        taps = taps.reshape(B, H // ph, ph, Wo, Cin, kw)
        patches = taps.permute(0, 1, 3, 2, 5, 4).reshape(B, H // ph, Wo, -1)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.weight.shape[0], -1)              # O, (ph, kw, Cin)
        y = L.linear(patches, w, self.proj.bias)
        return y if self.norm is None else self.norm(y)


class PatchMerging(nn.Module):
    """2x2 space-to-depth (channel blocks (0,0),(1,0),(0,1),(1,1)) then the
    fused LN(4C) + bias-free 4C -> 2C reduction."""

    def __init__(self, dim: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.norm = L.LayerNorm(4 * dim, eps, device=device, dtype=dtype)
        self.reduction = L.Linear(4 * dim, 2 * dim, False, device=device,
                                  dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _space_to_depth(x)
        B, H2, W2, C4 = x.shape
        d = x.dtype
        out = ln_linear(x.reshape(-1, C4), self.norm.weight.to(d),
                        self.norm.bias.to(d), self.reduction.weight.to(d),
                        eps=self.eps)
        return out.reshape(B, H2, W2, C4 // 2)


class PatchMergingV2(nn.Module):
    """Space-to-depth as :class:`PatchMerging`, then the bias-free 4C -> 2C
    reduction, then norm(2C) (reference: swin_transformer_v2.py:341-365)."""

    def __init__(self, dim: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.reduction = L.Linear(4 * dim, 2 * dim, False, device=device,
                                  dtype=dtype)
        self.norm = L.LayerNorm(2 * dim, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.reduction(_space_to_depth(x))
        return layer_norm_tokens(self.norm, y)


class PatchUnmerging(nn.Module):
    """1x1 conv C -> 2C then PixelShuffle(2): C/2 channels at 2x res."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.expand = L.Conv2d(dim, 2 * dim, 1, 1, True, device=device,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pixel_shuffle_nhwc(
            L.conv1x1(x, self.expand.weight, self.expand.bias), 2)


class PatchExpanding(nn.Module):
    """Bias-free C -> 2C linear, depth-to-space by 2 (channels split (p1,
    p2, c)), norm(C/2) (reference: tulip.py:126-140)."""

    def __init__(self, dim: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.expand = L.Linear(dim, 2 * dim, False, device=device,
                               dtype=dtype)
        self.norm = L.LayerNorm(dim // 2, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _depth_to_space(self.expand(x), 2)
        return layer_norm_tokens(self.norm, y)


class FinalPatchExpanding(nn.Module):
    """Bias-free C -> s^2 C linear, depth-to-space by s (channels split
    (p1, p2, c)), norm(C) (reference: tulip.py:144-159)."""

    def __init__(self, dim: int, scale: int, eps: float, *, device=None,
                 dtype=None):
        super().__init__()
        self.scale = scale
        self.expand = L.Linear(dim, scale * scale * dim, False,
                               device=device, dtype=dtype)
        self.norm = L.LayerNorm(dim, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _depth_to_space(self.expand(x), self.scale)
        return layer_norm_tokens(self.norm, y)


def _upsample(cfg: ModelConfig, dim: int, **kw) -> nn.Module:
    if cfg.patch_unmerging:
        return PatchUnmerging(dim, **kw)
    return PatchExpanding(dim, cfg.layer_norm_eps, **kw)


class Stage(nn.Module):
    def __init__(self, cfg: ModelConfig, stage, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if cfg.swin_v2:
            # v2 builds its relative index from the stage's (resolved)
            # window, v1 from the config window (tulip_tpu/models/tulip.py:
            # build_model)
            self.blocks = nn.ModuleList(
                SwinBlockV2(stage.dim, make_block_static(stage, j,
                                                         stage.window),
                            cfg.mlp_ratio, cfg.layer_norm_eps, cfg.qkv_bias,
                            **kw)
                for j in range(stage.depth))
            return
        self.blocks = nn.ModuleList(
            SwinBlockV1(stage.dim, make_block_static(stage, j, cfg.window_size),
                        cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                        cfg.layer_norm_eps, drop=cfg.drop_rate,
                        attn_drop=cfg.attn_drop_rate, **kw)
            for j in range(stage.depth))

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, **kw)
        return x


class TULIP(nn.Module):
    """The TULIP model for one :class:`ModelConfig` (reference: class TULIP,
    tulip/model/tulip.py:530-755).  Parameters are allocated empty: fill
    them with ``load_state_dict(init_params(cfg, generator))`` or from a
    checkpoint."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        n = cfg.num_layers
        self.patch_embed = PatchEmbed(cfg, **kw)
        self.layers = nn.ModuleList()
        for i, st in enumerate(cfg.encoder_stages):
            stage = Stage(cfg, st, **kw)
            if i < n - 1:
                merge = PatchMergingV2 if cfg.swin_v2 else PatchMerging
                stage.downsample = merge(st.dim, cfg.layer_norm_eps, **kw)
            self.layers.append(stage)
        self.first_patch_expanding = _upsample(
            cfg, cfg.embed_dim * 2 ** (n - 1), **kw)
        self.layers_up = nn.ModuleList()
        for i, st in enumerate(cfg.decoder_stages):
            stage = Stage(cfg, st, **kw)
            if i < n - 2:
                stage.upsample = _upsample(cfg, st.dim, **kw)
            self.layers_up.append(stage)
        self.skip_connection_layers = nn.ModuleList(
            L.Linear(st.dim * 2, st.dim, True, **kw)
            for st in cfg.decoder_stages)
        self.norm_up = L.LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, **kw)
        r2 = cfg.upscale_factor ** 2
        if cfg.pixel_shuffle:
            self.ps_head = nn.Module()
            self.ps_head.conv_expand = nn.ModuleList(
                [L.Conv2d(cfg.embed_dim, cfg.embed_dim * r2, 1, 1, True,
                          **kw)])
        else:
            self.final_patch_expanding = FinalPatchExpanding(
                cfg.embed_dim, cfg.upscale_factor, cfg.layer_norm_eps, **kw)
        self.decoder_pred = L.Conv2d(cfg.embed_dim, cfg.in_chans, 1, 1, False,
                                     **kw)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """norm_up + ps_head + decoder_pred as one fused two-matmul: the 1x1
        prediction conv commutes with PixelShuffle, so it folds into a dense
        (c*r^2, C*r^2) second weight (c = in_chans output channels) whose
        row (k, s) reads the expanded channels {c'*r^2 + s} with weight
        decoder_pred[k, c']; the (tokens, C*r^2) expansion never reaches
        memory.  Without the pixel-shuffle head: norm_up,
        FinalPatchExpanding and the 1x1 prediction conv."""
        if not self.cfg.pixel_shuffle:
            x = self.final_patch_expanding(layer_norm_tokens(self.norm_up, x))
            return L.conv1x1(x, self.decoder_pred.weight)
        B, H, W, C = x.shape
        s = self.cfg.upscale_factor
        r2 = s * s
        d = x.dtype
        conv = self.ps_head.conv_expand[0]
        w1 = conv.weight.reshape(C * r2, C).to(d)
        wpred = self.decoder_pred.weight.reshape(-1, C).to(d)   # (c, C)
        c = wpred.shape[0]
        rows = torch.arange(C * r2, device=x.device)
        w2 = torch.zeros(c, r2, C * r2, device=x.device, dtype=d)
        w2[:, rows % r2, rows] = wpred.repeat_interleave(r2, dim=1)
        out = two_matmul(
            x.reshape(-1, C), self.norm_up.weight.to(d),
            self.norm_up.bias.to(d), w1, conv.bias.to(d),
            w2.reshape(c * r2, C * r2), None, act="leaky", residual=False,
            eps=self.cfg.layer_norm_eps)
        out = out.reshape(B, H, W, c, s, s).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(B, H * s, W * s, c)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                dropout: bool = False,
                generator: Optional[L.Draws] = None) -> torch.Tensor:
        """NHWC input image -> NHWC prediction (reference: TULIP.forward,
        tulip.py:702-731).  ``train`` selects the blocks' training path
        (drop-path drawn from ``generator``), ``dropout`` activates the
        dropout sites (drawn from it too): pos_drop after the patch embed
        and the v1 blocks' attention, projection and MLP dropout."""
        n = self.cfg.num_layers
        kw = dict(train=train, dropout=dropout, generator=generator)
        x = self.patch_embed(x)
        x = L.dropout(x, self.cfg.drop_rate, generator, dropout)  # pos_drop
        x_save = []
        for i, stage in enumerate(self.layers):
            x_save.append(x)
            x = stage(x, **kw)
            if i < n - 1:
                x = stage.downsample(x)
        x = self.first_patch_expanding(x)
        for i, stage in enumerate(self.layers_up):
            x = torch.cat([x, x_save[n - i - 2]], dim=-1)
            x = self.skip_connection_layers[i](x)
            x = stage(x, **kw)
            if i < n - 2:
                x = stage.upsample(x)
        return self._head(x)


def forward_loss(pred: torch.Tensor, target: torch.Tensor,
                 log_transform: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 loss (+ de-logged pixel loss when log_transform), fp32
    (reference: tulip.py:690-700)."""
    pred32, tgt32 = pred.float(), target.float()
    loss = (pred32 - tgt32).abs().mean()
    if log_transform:
        pixel_loss = (torch.expm1(pred32) - torch.expm1(tgt32)).abs().mean()
    else:
        pixel_loss = loss
    return loss, pixel_loss


def apply_model(model: TULIP, x: torch.Tensor,
                target: Optional[torch.Tensor] = None, *, mode: str = "eval",
                mc_drop: bool = False, compute_dtype=torch.float32,
                generator: Optional[L.Draws] = None):
    """Public forward.  ``x``/``target`` are NCHW.  ``mode`` 'eval' is
    deterministic; 'mc' is model.eval() + active dropout at the config's
    rates; 'train' runs with autograd on, dropout and drop-path active.
    The draws come from ``generator`` (on x's device; a
    ``layers.RankDraws`` where x is one rank's share of a data-parallel
    batch; None draws nothing, as the JAX package's rng None).  Returns
    pred (NCHW) if ``mc_drop`` else (pred, total_loss, pixel_loss), as
    tulip_tpu.models.tulip.apply_model does."""
    cfg = model.cfg
    if mode not in ("train", "eval", "mc"):
        raise ValueError(f"unknown mode {mode!r}")
    train = mode == "train"
    with torch.set_grad_enabled(train):
        xh = x.permute(0, 2, 3, 1).to(compute_dtype).contiguous()
        pred = model(xh, train=train, dropout=mode != "eval",
                     generator=generator).permute(0, 3, 1, 2)
    if mc_drop:
        return pred
    total_loss, pixel_loss = forward_loss(pred, target, cfg.log_transform)
    return pred, total_loss, pixel_loss


# ---------------------------------------------------------------------------
# Parameter initialization (torch defaults, explicit generator)
# ---------------------------------------------------------------------------

def _block_params(dim: int, nh: int, g: torch.Generator, *,
                  mlp_ratio: float, qkv_bias: bool, swin_v2: bool,
                  window=None) -> Dict[str, torch.Tensor]:
    """One block's weights; ``window`` sizes v1's bias table."""
    hidden = int(dim * mlp_ratio)
    p = {}
    for k in ("norm1", "norm2"):
        p.update({f"{k}.{n}": t for n, t in L.layer_norm_init(dim).items()})
    if swin_v2:   # tulip_tpu/models/tulip.py:_attn_params
        sub = {"attn.qkv": L.torch_linear_trunc_init(dim, 3 * dim, False, g),
               "attn.cpb_mlp.0": L.torch_linear_trunc_init(2, CPB_HIDDEN,
                                                           True, g),
               "attn.cpb_mlp.2": L.torch_linear_trunc_init(CPB_HIDDEN, nh,
                                                           False, g)}
        if qkv_bias:
            p["attn.q_bias"] = torch.zeros(dim)
            p["attn.v_bias"] = torch.zeros(dim)
        p["attn.logit_scale"] = torch.full((nh, 1, 1), math.log(10.0))
    else:
        sub = {"attn.qkv": L.torch_linear_trunc_init(dim, 3 * dim,
                                                     qkv_bias, g)}
    sub.update({"attn.proj": L.torch_linear_trunc_init(dim, dim, True, g),
                "mlp.fc1": L.torch_linear_trunc_init(dim, hidden, True, g),
                "mlp.fc2": L.torch_linear_trunc_init(hidden, dim, True, g)})
    for k, d in sub.items():
        p.update({f"{k}.{n}": t for n, t in d.items()})
    if not swin_v2:   # drawn last, so a seed gives v1 the same weights
        wh, ww = window
        p["attn.relative_position_bias_table"] = L.trunc_normal(
            ((2 * wh - 1) * (2 * ww - 1), nh), 0.02, g)
    return p


def _merge_params(dim: int, swin_v2: bool,
                  g: torch.Generator) -> Dict[str, torch.Tensor]:
    """PatchMergingV2 norms the 2C output, v1's merge the 4C input."""
    return {**{f"norm.{n}": t for n, t in L.layer_norm_init(
                (2 if swin_v2 else 4) * dim).items()},
            **{f"reduction.{n}": t for n, t in L.torch_linear_trunc_init(
                4 * dim, 2 * dim, False, g).items()}}


def _upsample_params(dim: int, cfg: ModelConfig,
                     g: torch.Generator) -> Dict[str, torch.Tensor]:
    if cfg.patch_unmerging:
        return {f"expand.{n}": t for n, t in
                L.torch_conv_init(2 * dim, dim, 1, 1, True, g).items()}
    return {"expand.weight": L.torch_linear_trunc_init(
                dim, 2 * dim, False, g)["weight"],
            **{f"norm.{n}": t for n, t in
               L.layer_norm_init(dim // 2).items()}}


def init_params(cfg: ModelConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Full fp32 CPU state dict for :class:`TULIP` (reference init:
    TULIP.init_weights + torch module defaults, tulip.py:586-594)."""
    g = generator
    n = cfg.num_layers
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        out.update({f"{prefix}.{k}": v for k, v in d.items()})

    blk = dict(mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
               swin_v2=cfg.swin_v2, window=cfg.window_size)

    kw = 8 if cfg.circular_padding else cfg.patch_size[1]
    put("patch_embed.proj", L.torch_conv_init(
        cfg.embed_dim, cfg.in_chans, cfg.patch_size[0], kw, True, g))
    if cfg.patch_norm:
        put("patch_embed.norm", L.layer_norm_init(cfg.embed_dim))
    for i, st in enumerate(cfg.encoder_stages):
        for j in range(st.depth):
            put(f"layers.{i}.blocks.{j}", _block_params(
                st.dim, st.num_heads, g, **blk))
        if i < n - 1:
            put(f"layers.{i}.downsample", _merge_params(st.dim, cfg.swin_v2,
                                                        g))
    put("first_patch_expanding",
        _upsample_params(cfg.embed_dim * 2 ** (n - 1), cfg, g))
    for i, st in enumerate(cfg.decoder_stages):
        for j in range(st.depth):
            put(f"layers_up.{i}.blocks.{j}", _block_params(
                st.dim, st.num_heads, g, **blk))
        if i < n - 2:
            put(f"layers_up.{i}.upsample", _upsample_params(st.dim, cfg, g))
    for i, st in enumerate(cfg.decoder_stages):
        put(f"skip_connection_layers.{i}",
            L.torch_linear_trunc_init(2 * st.dim, st.dim, True, g))
    put("norm_up", L.layer_norm_init(cfg.embed_dim))
    s2 = cfg.upscale_factor ** 2
    if cfg.pixel_shuffle:
        put("ps_head.conv_expand.0", L.torch_conv_init(
            cfg.embed_dim * s2, cfg.embed_dim, 1, 1, True, g))
    else:
        put("final_patch_expanding.expand", L.torch_linear_trunc_init(
            cfg.embed_dim, s2 * cfg.embed_dim, False, g))
        put("final_patch_expanding.norm", L.layer_norm_init(cfg.embed_dim))
    out["decoder_pred.weight"] = L.torch_conv_init(
        cfg.in_chans, cfg.embed_dim, 1, 1, False, g)["weight"]
    return out


# ---------------------------------------------------------------------------
# Factories (reference: tulip/model/tulip.py:739-755)
# ---------------------------------------------------------------------------

def tulip_base(*, device=None, dtype=torch.float32, **kwargs) -> TULIP:
    return TULIP(model_config("tulip_base", **kwargs), device=device,
                 dtype=dtype)


def tulip_large(*, device=None, dtype=torch.float32, **kwargs) -> TULIP:
    return TULIP(model_config("tulip_large", **kwargs), device=device,
                 dtype=dtype)
