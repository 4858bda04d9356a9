"""Range image -> point cloud projections on the device (port of the
``*_jnp`` functions of tulip_tpu/eval/geometry.py).

Same math as the JAX versions: the per-pixel angle tables are computed with
numpy exactly as there and moved to the image's device; the trigonometry
and products run in fp32 torch.  The numpy host versions, the Ouster
OS1-128 LUTs and the constants are imported from ``tulip_tpu.eval.geometry``,
which does not import jax.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tulip_tpu.eval.geometry import (  # noqa: F401
    ANGLE_OFF, LIDAR_TO_SENSOR_Z_OFFSET, ORIGIN_OFFSET, OS1_128_AZIMUTH_LUT,
    OS1_128_ELEVATION_LUT, OS1_128_OFFSET_LUT, img_to_pcd_carla,
    img_to_pcd_durlar, img_to_pcd_kitti,
)


def _t(arr, like):
    return torch.as_tensor(np.asarray(arr, dtype=np.float32),
                           device=like.device)


def img_to_pcd_carla_torch(img_range, maximum_range: float = 80):
    """Uniform -15..15 deg x -180..180 deg grid; (rows*cols, 3)."""
    rows, cols = img_range.shape[:2]
    v_dir = np.linspace(-15, 15, rows)
    h_dir = np.linspace(-180, 180, cols, endpoint=False)
    v_ang = _t(np.deg2rad(np.repeat(v_dir, cols).astype(np.float32)),
               img_range)
    h_ang = _t(np.deg2rad(np.tile(h_dir, rows).astype(np.float32)),
               img_range)
    r = img_range.reshape(-1) * maximum_range
    return torch.stack((torch.sin(h_ang) * torch.cos(v_ang) * r,
                        torch.cos(h_ang) * torch.cos(v_ang) * r,
                        torch.sin(v_ang) * r), dim=-1)


def img_to_pcd_kitti_torch(img_range, maximum_range: float = 120,
                           low_res: bool = False):
    """KITTI's fixed 64x1024 (16x1024 low-res) grid, 26.8 deg FOV from
    +24.8 deg; (rows*1024, 3)."""
    image_rows = 16 if low_res else 64
    image_cols = 1024
    ang_res_y = 26.8 / (image_rows - 1)
    ang_res_x = 360.0 / image_cols
    rows = np.repeat(np.arange(image_rows, dtype=np.float32), image_cols)
    cols = np.tile(np.arange(image_cols, dtype=np.float32), image_rows)
    vertical = _t((rows * ang_res_y - 24.8) / 180.0 * np.pi, img_range)
    horizon = _t((-(cols + 1 - image_cols / 2) * ang_res_x + 90.0)
                 / 180.0 * np.pi, img_range)
    length = img_range.reshape(-1) * maximum_range
    return torch.stack((torch.sin(horizon) * torch.cos(vertical) * length,
                        torch.cos(horizon) * torch.cos(vertical) * length,
                        torch.sin(vertical) * length), dim=-1)


def img_to_pcd_durlar_torch(img_range, maximum_range: float = 120):
    """Ouster OS1-128 beam model with destaggering, in the point order of
    the numpy ``img_to_pcd_durlar``.  The destagger scatter is, per image
    row v, a circular shift by -offset[v], and the offset LUT repeats every
    4 rows (48, 32, 16, 0): so it is 4 static rolls on a (rows/4, 4, cols)
    view, as in the JAX version."""
    rows, cols = img_range.shape[:2]
    u = np.arange(cols)
    v = np.arange(rows)
    azimuth_radians = math.pi * 2.0 / cols
    encoder = _t(2.0 * math.pi - ((cols + u) % cols) * azimuth_radians,
                 img_range)[None, :]
    elevation = _t(math.pi * OS1_128_ELEVATION_LUT[v] / 180.0,
                   img_range)[:, None]
    r = img_range * maximum_range - ORIGIN_OFFSET            # (rows, cols)
    cos_el = torch.cos(elevation)
    x_l = (r * torch.cos(encoder + ANGLE_OFF) * cos_el
           + ORIGIN_OFFSET * torch.cos(encoder))
    y_l = (r * torch.sin(encoder + ANGLE_OFF) * cos_el
           + ORIGIN_OFFSET * torch.sin(encoder))
    z_l = r * torch.sin(elevation)
    pts = torch.stack((-x_l, -y_l, z_l + LIDAR_TO_SENSOR_Z_OFFSET), dim=-1)
    g = pts.reshape(rows // 4, 4, cols, 3)
    offs = OS1_128_OFFSET_LUT[:4]
    rolled = torch.stack([torch.roll(g[:, j], -int(offs[j]), dims=1)
                          for j in range(4)], dim=1)
    return rolled.reshape(rows * cols, 3)
