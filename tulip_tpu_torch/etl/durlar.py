"""DurLAR (Ouster OS1-128) ETL: destaggered projection of .bin scans to
(rows, cols) range + intensity images.

An offline host conversion in numpy, no device (the port's copy of
tulip_tpu/etl/durlar.py).  Parity target: durlar_utils/bin_to_img.py:39-82,
the reference's per-pixel Python loop, here vectorized with the same math.
The OS1-128 constants are the port's own (eval/geometry.py).
"""

from __future__ import annotations

import numpy as np

from ..eval.geometry import (
    LIDAR_TO_SENSOR_Z_OFFSET, ORIGIN_OFFSET, OS1_128_OFFSET_LUT,
)


def pcd_to_img(scan: np.ndarray, rows: int = 128, cols: int = 2048):
    """scan: (rows*cols, 4) x,y,z,intensity in staggered sensor order.
    Returns (range_map, intensity_map), each (rows, cols).

    Range per the Ouster manual: compensate beam-to-center offset in xy and
    beam-to-sensor-bottom offset in z, then re-add the origin offset
    (reference: bin_to_img.py:54-74)."""
    u = np.arange(cols)[None, :]                       # (1, cols)
    v = np.arange(rows)[:, None]                       # (rows, 1)
    vv = (u + cols - OS1_128_OFFSET_LUT[:rows][v]) % cols
    idx = v * cols + vv                                # (rows, cols)

    pts = scan[idx.reshape(-1)]                        # (rows*cols, 4)
    pts = pts.reshape(rows, cols, 4)

    xy_range = np.sqrt(pts[..., 0] ** 2 + pts[..., 1] ** 2) - ORIGIN_OFFSET
    z = pts[..., 2] - LIDAR_TO_SENSOR_Z_OFFSET
    range_map = np.sqrt(xy_range ** 2 + z ** 2) + ORIGIN_OFFSET
    intensity_map = pts[..., 3]
    return range_map, intensity_map
