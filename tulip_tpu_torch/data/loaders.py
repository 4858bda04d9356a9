"""Range-image file loaders.

Behavioural parity with the reference loaders
(tulip/util/datasets.py:169-193): same file formats, same channel selection,
same orientation fix-ups.  All loaders return float32 numpy arrays of shape
(H, W).  The port's copy of tulip_tpu/data/loaders.py, numpy path only.
"""

from __future__ import annotations

import numpy as np


def bin_loader(path: str) -> np.ndarray:
    """KITTI-style packed float32 (64, 1024, 2) range+intensity map
    (reference: tulip/util/datasets.py:169-173)."""
    with open(path, "rb") as f:
        range_intensity_map = np.fromfile(f, dtype=np.float32).reshape(64, 1024, 2)
    return range_intensity_map


def npy_loader(path: str) -> np.ndarray:
    """.npy (H, W, 2) range+intensity; keeps only channel 0 (range)
    (reference: tulip/util/datasets.py:175-179)."""
    with open(path, "rb") as f:
        range_intensity_map = np.load(f)
        range_map = range_intensity_map[..., 0]
    return np.ascontiguousarray(range_map.astype(np.float32))


def rimg_loader(path: str) -> np.ndarray:
    """CARLA .rimg: 2 uint64 header (size[0]=H, size[1]=W) then a float16
    payload stored as (W, H); reshape(size[1], size[0]) -> (W, H), transpose
    -> (H, W), then flip on both axes
    (reference: tulip/util/datasets.py:181-193)."""
    with open(path, "rb") as f:
        size = np.fromfile(f, dtype=np.uint64, count=2)
        range_image = np.fromfile(f, dtype=np.float16)
    range_image = range_image.reshape(int(size[1]), int(size[0]))
    range_image = range_image.transpose()
    return np.ascontiguousarray(np.flip(range_image).astype(np.float32))
