"""2-D sin-cos positional embeddings and their interpolation to a new grid
(a copy of tulip_tpu/utils/pos_embed.py: numpy only).

The reference ships util/pos_embed.py, whose ``interpolate_pos_embed`` is
imported but never called (TULIP uses a relative position bias).
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size, cls_token: bool = False
                            ) -> np.ndarray:
    """grid_size: int (square) or (H, W)."""
    if isinstance(grid_size, int):
        grid_size = (grid_size, grid_size)
    grid_h = np.arange(grid_size[0], dtype=np.float64)
    grid_w = np.arange(grid_size[1], dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)          # W first, torch-MAE convention
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size[0], grid_size[1])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate([np.zeros((1, embed_dim)), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def interpolate_pos_embed(pos_embed: np.ndarray, new_grid, old_grid,
                          num_extra_tokens: int = 1) -> np.ndarray:
    """Bicubic-free (bilinear) resize of a (1, N+extra, D) pos-embed table to
    a new grid; numpy-only so it can run at checkpoint-load time."""
    extra = pos_embed[:, :num_extra_tokens]
    tokens = pos_embed[:, num_extra_tokens:]
    d = tokens.shape[-1]
    oh, ow = old_grid
    nh, nw = new_grid
    grid = tokens.reshape(oh, ow, d)
    ys = np.linspace(0, oh - 1, nh)
    xs = np.linspace(0, ow - 1, nw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, oh - 1)
    x1 = np.minimum(x0 + 1, ow - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    out = (grid[y0][:, x0] * (1 - wy) * (1 - wx)
           + grid[y0][:, x1] * (1 - wy) * wx
           + grid[y1][:, x0] * wy * (1 - wx)
           + grid[y1][:, x1] * wy * wx)
    return np.concatenate([extra, out.reshape(1, nh * nw, d)], axis=1)
