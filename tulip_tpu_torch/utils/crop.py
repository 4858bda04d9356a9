"""RandomResizedCrop for range maps (port of tulip_tpu/utils/crop.py;
numpy, host side).

The reference ships util/crop.py (a RandomResizedCrop never imported at
runtime).  A box of a random area fraction and log-uniform aspect ratio
is cropped and resized back bilinearly.  The draws come from the
``np.random.RandomState`` the transform is given (a fresh one by
default); the JAX package's draws from numpy's global state, which is a
RandomState too, so one seed gives both the same boxes.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 rng: Optional[np.random.RandomState] = None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.rng = np.random.RandomState() if rng is None else rng

    def _sample_box(self, h, w):
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * self.rng.uniform(*self.scale)
            aspect = math.exp(self.rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = self.rng.randint(0, h - ch + 1)
                j = self.rng.randint(0, w - cw + 1)
                return i, j, ch, cw
        return 0, 0, h, w  # fallback: the whole image

    @staticmethod
    def _resize_bilinear(img, out_h, out_w):
        h, w = img.shape[-2:]
        ys = np.linspace(0, h - 1, out_h)
        xs = np.linspace(0, w - 1, out_w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (ys - y0)[:, None]
        wx = (xs - x0)[None, :]
        out = (img[..., y0, :][..., :, x0] * (1 - wy) * (1 - wx)
               + img[..., y0, :][..., :, x1] * (1 - wy) * wx
               + img[..., y1, :][..., :, x0] * wy * (1 - wx)
               + img[..., y1, :][..., :, x1] * wy * wx)
        return out.astype(img.dtype)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: (C, H, W) float array -> (C, *size)."""
        h, w = img.shape[-2:]
        i, j, ch, cw = self._sample_box(h, w)
        return self._resize_bilinear(img[..., i:i + ch, j:j + cw], *self.size)
