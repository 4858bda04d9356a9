"""Pure-numpy transform pipeline for range images.

Parity targets: tulip/util/datasets.py:55-150.  All transforms operate on
channel-first float32 arrays (C, H, W), matching the reference convention
after torchvision ``ToTensor`` lifts an (H, W) ndarray to (1, H, W).
Everything here runs on the host data path; the device never sees Python
control flow.
"""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ToChannelFirst:
    """(H, W) float ndarray -> (1, H, W); equivalent of torchvision
    ToTensor on a float image (no 1/255 scaling for float inputs)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 2:
            return x[None, ...]
        if x.ndim == 3:  # (H, W, C) -> (C, H, W)
            return np.transpose(x, (2, 0, 1))
        return x


class ScaleTensor:
    """Multiply by a scale factor (reference: datasets.py:137-141)."""

    def __init__(self, scale_factor: float):
        self.scale_factor = scale_factor

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x * self.scale_factor


class FilterInvalidPixels:
    """Zero out pixels outside [min_range, max_range]
    (reference: datasets.py:143-150)."""

    def __init__(self, min_range: float, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.where((x >= self.min_range) & (x <= self.max_range), x, 0)


class LogTransform:
    """log1p (reference: datasets.py:68-70)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.log1p(x)


class DownsampleTensor:
    """Strided row subsampling; derives the low-res input from the high-res
    image (reference: datasets.py:117-125)."""

    def __init__(self, h_high_res: int, downsample_factor: int, random: bool = False):
        index = np.random.randint(0, downsample_factor) if random else 0
        self.low_res_index = range(0 + index, h_high_res + index, downsample_factor)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x[:, self.low_res_index, :]


class DownsampleTensorWidth:
    """Strided column subsampling (reference: datasets.py:127-135)."""

    def __init__(self, w_high_res: int, downsample_factor: int, random: bool = False):
        index = np.random.randint(0, downsample_factor) if random else 0
        self.low_res_index = range(0 + index, w_high_res + index, downsample_factor)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return x[:, :, self.low_res_index]


class RandomRollRangeMap:
    """Horizontal roll augment.  NOTE (parity): the reference draws the shift
    once at transform construction time (datasets.py:99-103), i.e. one shift
    per dataset instantiation, shared between the low/high-res pipelines."""

    def __init__(self, h_img: int = 2048, shift=None):
        self.shift = int(shift) if shift is not None else int(np.random.randint(0, h_img))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.roll(x, shift=self.shift, axis=-1)


class AddGaussianNoise:
    """Dead in the reference (datasets.py:55-61, never enabled); kept for
    API-surface completeness.  NOTE: the reference returns pure noise, not
    img+noise — preserved."""

    def __init__(self, mu: float, sigma: float):
        self.mu = mu
        self.sigma = sigma

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.random.randn(*x.shape).astype(np.float32) * self.sigma + self.mu


class CropRanges:
    """Dead in the reference (datasets.py:73-80); returns (filtered, count)."""

    def __init__(self, min_dist: float, max_dist: float):
        self.min_dist = min_dist
        self.max_dist = max_dist

    def __call__(self, x: np.ndarray):
        mask = (x >= self.min_dist) & (x < self.max_dist)
        return np.where(mask, x, 0), mask.sum()


class KeepCloseScan:
    """Dead in the reference (datasets.py:82-86)."""

    def __init__(self, max_dist: float):
        self.max_dist = max_dist

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.where(x < self.max_dist, x, 0)


class KeepFarScan:
    """Dead in the reference (datasets.py:88-92)."""

    def __init__(self, min_dist: float):
        self.min_dist = min_dist

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.where(x > self.min_dist, x, 0)


class DepthwiseConcatenation:
    """Dead in the reference (datasets.py:108-115); rows -> channels."""

    def __init__(self, h_high_res: int, downsample_factor: int):
        self.low_res_indices = [range(i, h_high_res + i, downsample_factor)
                                for i in range(downsample_factor)]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.concatenate([x[:, idx, :] for idx in self.low_res_indices], axis=0)
