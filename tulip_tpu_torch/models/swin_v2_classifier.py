"""Swin-Transformer-V2 image classifier (port of
tulip_tpu/models/swin_v2_classifier.py).

The reference carries the full SwinTransformerV2 classifier
(tulip/model/swin_transformer_v2.py:384-641: PatchEmbed, BasicLayer, the
average-pool head).  Here it is built from the port's own Swin-v2 blocks
(:class:`~tulip_tpu_torch.models.swin.SwinBlockV2`: cosine attention as
PyTorch ops, the MLP on the two-matmul kernel K3, both post-norms on the
LayerNorm kernel K14) and :class:`~tulip_tpu_torch.models.tulip.
PatchMergingV2` (its norm on K14), under the reference's state-dict keys,
so :func:`~tulip_tpu_torch.utils.checkpoint.state_dict_from_jax` carries
the JAX package's parameters across.

The defaults are SwinV2-T (Liu et al., "Swin Transformer V2", CVPR 2022:
``SwinTransformerV2.__init__`` of microsoft/Swin-Transformer): 224 x 224,
patch 4, 3 channels, 1,000 classes, C 96, depths 2 / 2 / 6 / 2, heads
3 / 6 / 12 / 24, window 7, MLP ratio 4.  A stage whose grid is no larger
than the window takes the whole grid as its window, unshifted
(swin_transformer_v2.py:230-233): SwinV2-T's last stage, 7 x 7.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import StageConfig
from . import layers as L
from .swin import BlockStatic, SwinBlockV2, layer_norm_tokens, make_block_static
from .tulip import PatchMergingV2, _block_params, _merge_params


def stage_statics(img_size, patch_size: int, embed_dim: int, depths,
                  num_heads, window_size: int, drop_path_rate: float
                  ) -> Tuple[Tuple[BlockStatic, ...], ...]:
    """Each stage's block geometry, as tulip_tpu's ``build_swin_v2``
    resolves it: grids halved between stages, the window clamped to
    min(grid) with no shift where min(grid) <= window."""
    grid = (img_size[0] // patch_size, img_size[1] // patch_size)
    total = sum(depths)
    dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
    stages, ofs = [], 0
    for i, d in enumerate(depths):
        if min(grid) <= window_size:
            w, shift = min(grid), (0, 0)
        else:
            w, shift = window_size, (window_size // 2, window_size // 2)
        stage = StageConfig(dim=embed_dim * 2 ** i, depth=d,
                            num_heads=num_heads[i], grid=grid, window=(w, w),
                            shift=shift, drop_path=tuple(dpr[ofs:ofs + d]))
        stages.append(tuple(make_block_static(stage, j, (w, w))
                            for j in range(d)))
        ofs += d
        grid = (grid[0] // 2, grid[1] // 2)
    return tuple(stages)


class _PatchEmbed(nn.Module):
    """A p x p stride-p convolution with bias (as one matmul over the
    non-overlapping patches: VALID padding, so a ragged edge is dropped),
    then LayerNorm."""

    def __init__(self, in_chans: int, dim: int, patch: int, eps: float, *,
                 device=None, dtype=None):
        super().__init__()
        self.proj = L.Conv2d(in_chans, dim, patch, patch, True,
                             device=device, dtype=dtype)
        self.norm = L.LayerNorm(dim, eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, Cin) -> (B, H / p, W / p, C)."""
        B, H, W, Cin = x.shape
        p = self.proj.weight.shape[-1]
        Ho, Wo = H // p, W // p
        x = x[:, :Ho * p, :Wo * p]
        x = x.reshape(B, Ho, p, Wo, p, Cin).permute(0, 1, 3, 2, 4, 5)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.weight.shape[0], -1)              # O, (p, p, Cin)
        y = L.linear(x.reshape(B, Ho, Wo, p * p * Cin), w, self.proj.bias)
        return layer_norm_tokens(self.norm, y)


class _Stage(nn.Module):
    def __init__(self, dim: int, blocks, mlp_ratio: float, eps: float,
                 qkv_bias: bool, **kw):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlockV2(dim, st, mlp_ratio, eps, qkv_bias, **kw)
            for st in blocks)


class SwinV2Classifier(nn.Module):
    """The classifier for one geometry (:func:`build_swin_v2` makes it).
    Parameters are allocated empty: fill them with
    ``load_state_dict(init_swin_v2_params(model, generator))`` or from the
    JAX package's parameters (``utils.checkpoint.load_jax_params``)."""

    def __init__(self, img_size, patch_size: int, in_chans: int,
                 num_classes: int, embed_dim: int, depths, num_heads,
                 window_size: int, mlp_ratio: float, qkv_bias: bool,
                 drop_path_rate: float, layer_norm_eps: float, *,
                 device=None, dtype=None):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size, self.in_chans = patch_size, in_chans
        self.num_classes, self.embed_dim = num_classes, embed_dim
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.window_size, self.mlp_ratio = window_size, mlp_ratio
        self.qkv_bias, self.layer_norm_eps = qkv_bias, layer_norm_eps
        self.stages = stage_statics(self.img_size, patch_size, embed_dim,
                                    depths, num_heads, window_size,
                                    drop_path_rate)
        kw = dict(device=device, dtype=dtype)
        eps = layer_norm_eps
        self.patch_embed = _PatchEmbed(in_chans, embed_dim, patch_size, eps,
                                       **kw)
        self.layers = nn.ModuleList()
        for i, blocks in enumerate(self.stages):
            dim = embed_dim * 2 ** i
            stage = _Stage(dim, blocks, mlp_ratio, eps, qkv_bias, **kw)
            if i < len(self.stages) - 1:
                stage.downsample = PatchMergingV2(dim, eps, **kw)
            self.layers.append(stage)
        final = embed_dim * 2 ** (len(depths) - 1)
        self.norm = L.LayerNorm(final, eps, **kw)
        self.head = L.Linear(final, num_classes, True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> logits (B, num_classes), in x's dtype
        (tulip_tpu's ``apply_swin_v2``): patch embed and its norm, the
        stages with PatchMergingV2 between them, the final norm, the mean
        over the grid, the head."""
        x = self.patch_embed(x.permute(0, 2, 3, 1))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = layer_norm_tokens(self.norm, x).mean(dim=(1, 2))
        return L.linear(x, self.head.weight, self.head.bias)


def build_swin_v2(img_size=(224, 224), patch_size=4, in_chans=3,
                  num_classes=1000, embed_dim=96, depths=(2, 2, 6, 2),
                  num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
                  qkv_bias=True, drop_path_rate=0.1, layer_norm_eps=1e-5, *,
                  device="cuda", dtype=torch.float32) -> SwinV2Classifier:
    """The classifier with tulip_tpu's ``build_swin_v2`` arguments and
    defaults (SwinV2-T), its parameters allocated empty on ``device``
    (the GPU unless the caller asks for another)."""
    return SwinV2Classifier(img_size, patch_size, in_chans, num_classes,
                            embed_dim, depths, num_heads, window_size,
                            mlp_ratio, qkv_bias, drop_path_rate,
                            layer_norm_eps, device=device, dtype=dtype)


def init_swin_v2_params(model: SwinV2Classifier,
                        generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Full fp32 CPU state dict of ``model``, with tulip_tpu's
    ``init_swin_v2_params`` keys and shapes and its initializers (torch
    defaults and TULIP.init_weights), drawn from ``generator``."""
    g = generator
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, d):
        out.update({f"{prefix}.{k}": v for k, v in d.items()})

    p = model.patch_size
    put("patch_embed.proj", L.torch_conv_init(model.embed_dim, model.in_chans,
                                              p, p, True, g))
    put("patch_embed.norm", L.layer_norm_init(model.embed_dim))
    for i, blocks in enumerate(model.stages):
        dim = model.embed_dim * 2 ** i
        for j in range(len(blocks)):
            put(f"layers.{i}.blocks.{j}", _block_params(
                dim, model.num_heads[i], g, mlp_ratio=model.mlp_ratio,
                qkv_bias=model.qkv_bias, swin_v2=True))
        if i < len(model.stages) - 1:
            put(f"layers.{i}.downsample", _merge_params(dim, True, g))
    final = model.embed_dim * 2 ** (len(model.depths) - 1)
    put("norm", L.layer_norm_init(final))
    put("head", L.torch_linear_trunc_init(final, model.num_classes, True, g))
    return out
