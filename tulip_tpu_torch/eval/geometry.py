"""Range image -> point cloud projections (port of
tulip_tpu/eval/geometry.py; parity target tulip/util/evaluation.py:7-116).

Each sensor model is here twice: the vectorized numpy host version
(``img_to_pcd_*``, with the Ouster OS1-128 LUTs and constants; copies of
the JAX package's, the same numpy code) and a torch version
(``img_to_pcd_*_torch``) for the on-device metric path, with the math of the
``*_jnp`` functions: the per-pixel angle tables are computed with numpy
exactly as there and moved to the image's device; the trigonometry and
products run in fp32 torch.

The Ouster OS1-128 LUTs describe the DurLAR sensor (beam elevation /
azimuth offsets and the per-column destagger offsets published in the Ouster
software manual); the reference carries the same calibration tables at
tulip/util/evaluation.py:7-11.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Ouster OS1-128 calibration (sensor data sheet values; same tables as
# reference evaluation.py:7-11 / durlar_utils/bin_to_img.py:8-12)
OS1_128_OFFSET_LUT = np.tile(np.array([48, 32, 16, 0], dtype=np.int64), 32)

OS1_128_AZIMUTH_LUT = np.array([
    4.23, 1.43, -1.38, -4.18, 4.23, 1.43, -1.38, -4.18, 4.24, 1.43, -1.38, -4.18,
    4.24, 1.42, -1.38, -4.19, 4.23, 1.43, -1.38, -4.19, 4.23, 1.43, -1.39, -4.19,
    4.23, 1.42, -1.39, -4.2, 4.23, 1.43, -1.39, -4.19, 4.23, 1.42, -1.4, -4.2,
    4.23, 1.42, -1.4, -4.2, 4.22, 1.41, -1.4, -4.21, 4.22, 1.41, -1.39, -4.2,
    4.22, 1.41, -1.4, -4.21, 4.22, 1.41, -1.4, -4.21, 4.22, 1.41, -1.4, -4.21,
    4.22, 1.41, -1.41, -4.21, 4.22, 1.41, -1.41, -4.21, 4.21, 1.4, -1.41, -4.21,
    4.21, 1.41, -1.41, -4.21, 4.22, 1.41, -1.42, -4.22, 4.22, 1.4, -1.41, -4.22,
    4.21, 1.41, -1.42, -4.22, 4.22, 1.4, -1.41, -4.22, 4.21, 1.4, -1.41, -4.23,
    4.21, 1.4, -1.42, -4.23, 4.21, 1.4, -1.42, -4.22, 4.21, 1.39, -1.42, -4.22,
    4.21, 1.4, -1.42, -4.21, 4.21, 1.4, -1.42, -4.22, 4.2, 1.4, -1.41, -4.22,
    4.2, 1.4, -1.42, -4.22, 4.2, 1.4, -1.42, -4.22])

OS1_128_ELEVATION_LUT = np.array([
    21.42, 21.12, 20.81, 20.5, 20.2, 19.9, 19.58, 19.26, 18.95, 18.65, 18.33,
    18.02, 17.68, 17.37, 17.05, 16.73, 16.4, 16.08, 15.76, 15.43, 15.1, 14.77,
    14.45, 14.11, 13.78, 13.45, 13.13, 12.79, 12.44, 12.12, 11.77, 11.45, 11.1,
    10.77, 10.43, 10.1, 9.74, 9.4, 9.06, 8.72, 8.36, 8.02, 7.68, 7.34, 6.98,
    6.63, 6.29, 5.95, 5.6, 5.25, 4.9, 4.55, 4.19, 3.85, 3.49, 3.15, 2.79, 2.44,
    2.1, 1.75, 1.38, 1.03, 0.68, 0.33, -0.03, -0.38, -0.73, -1.07, -1.45, -1.8,
    -2.14, -2.49, -2.85, -3.19, -3.54, -3.88, -4.26, -4.6, -4.95, -5.29, -5.66,
    -6.01, -6.34, -6.69, -7.05, -7.39, -7.73, -8.08, -8.44, -8.78, -9.12, -9.45,
    -9.82, -10.16, -10.5, -10.82, -11.19, -11.52, -11.85, -12.18, -12.54, -12.87,
    -13.2, -13.52, -13.88, -14.21, -14.53, -14.85, -15.2, -15.53, -15.84, -16.16,
    -16.5, -16.83, -17.14, -17.45, -17.8, -18.11, -18.42, -18.72, -19.06, -19.37,
    -19.68, -19.97, -20.31, -20.61, -20.92, -21.22])

ORIGIN_OFFSET = 0.015806
LIDAR_TO_SENSOR_Z_OFFSET = 0.03618
ANGLE_OFF = math.pi * 4.2285 / 180.0


def img_to_pcd_durlar(img_range: np.ndarray, maximum_range: float = 120) -> np.ndarray:
    """Ouster OS1-128 beam-model reprojection with destaggering
    (reference: evaluation.py:19-50).  img_range: (H, W) normalized [0, 1].
    Returns (H*W, 3) points ordered by the destagger index (idx_from_px)."""
    rows, cols = img_range.shape[:2]
    # (u, v) grid in the reference's column-major stacking order
    uu, vv = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    u = uu.reshape(-1)
    v = vv.reshape(-1)

    # destagger index (reference: idx_from_px, evaluation.py:19-22)
    vcol = (u + cols - OS1_128_OFFSET_LUT[v]) % cols
    indices = v * cols + vcol

    # px_to_xyz (reference: evaluation.py:25-38)
    p_range = img_range.transpose().reshape(-1) * maximum_range
    azimuth_radians = math.pi * 2.0 / cols
    encoder = 2.0 * math.pi - ((cols + u) % cols) * azimuth_radians
    elevation = math.pi * OS1_128_ELEVATION_LUT[v] / 180.0

    r = p_range - ORIGIN_OFFSET
    cos_el = np.cos(elevation)
    x_lidar = r * np.cos(encoder + ANGLE_OFF) * cos_el + ORIGIN_OFFSET * np.cos(encoder)
    y_lidar = r * np.sin(encoder + ANGLE_OFF) * cos_el + ORIGIN_OFFSET * np.sin(encoder)
    z_lidar = r * np.sin(elevation)
    points_all = np.stack((-x_lidar, -y_lidar,
                           z_lidar + LIDAR_TO_SENSOR_Z_OFFSET), axis=-1)

    points = np.zeros((rows * cols, 3))
    points[indices, :] = points_all
    return points


def img_to_pcd_kitti(img_range: np.ndarray, maximum_range: float = 120,
                     low_res: bool = False, intensity=None) -> np.ndarray:
    """Uniform spherical grid, 64x1024, 26.8 deg FOV from +24.8 deg
    (reference: evaluation.py:52-87)."""
    image_rows = 16 if low_res else 64
    image_cols = 1024
    ang_start_y = 24.8
    ang_res_y = 26.8 / (image_rows - 1)
    ang_res_x = 360.0 / image_cols

    rows = np.repeat(np.arange(image_rows, dtype=np.float64), image_cols)
    cols = np.tile(np.arange(image_cols, dtype=np.float64), image_rows)

    vertical = (np.float32(rows * ang_res_y) - ang_start_y) / 180.0 * np.pi
    horizon = (-np.float32(cols + 1 - image_cols / 2) * ang_res_x + 90.0) / 180.0 * np.pi

    length = img_range.reshape(image_rows * image_cols) * maximum_range
    x = np.sin(horizon) * np.cos(vertical) * length
    y = np.cos(horizon) * np.cos(vertical) * length
    z = np.sin(vertical) * length
    if intensity is not None:
        return np.column_stack((x, y, z, intensity.reshape(-1)))
    return np.column_stack((x, y, z))


def img_to_pcd_carla(img_range: np.ndarray, maximum_range: float = 80) -> np.ndarray:
    """Uniform grid -15..15 deg x -180..180 deg (reference: evaluation.py:90-116)."""
    rows, cols = img_range.shape[:2]
    v_dir = np.linspace(start=-15, stop=15, num=rows)
    h_dir = np.linspace(start=-180, stop=180, num=cols, endpoint=False)

    v_angles = np.deg2rad(np.repeat(v_dir, cols).astype(np.float32))
    h_angles = np.deg2rad(np.tile(h_dir, rows).astype(np.float32))

    r = img_range.flatten() * maximum_range
    x = np.sin(h_angles) * np.cos(v_angles) * r
    y = np.cos(h_angles) * np.cos(v_angles) * r
    z = np.sin(v_angles) * r
    return np.stack((x, y, z), axis=-1)


# ---------------------------------------------------------------------------
# torch variants (device path; same math, static shapes)
# ---------------------------------------------------------------------------


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
