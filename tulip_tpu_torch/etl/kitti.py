"""KITTI ETL: spherical projection of velodyne .bin scans to 64x1024x2
range+intensity .npy maps.

An offline host conversion in numpy, no device (the port's copy of
tulip_tpu/etl/kitti.py).  Parity target: kitti_utils/sample_kitti_dataset.py:
24-78 of the reference: the same binning (arctan2 row/col ids, inverted-y
horizontal angle, column wrap), the same range clamps, the same output
layout, vectorized.
"""

from __future__ import annotations

import numpy as np


def load_from_bin(bin_path: str) -> np.ndarray:
    """(N, 4) x,y,z,intensity float32 (reference: sample_kitti_dataset.py:69-72)."""
    return np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)


def create_range_map(points_array: np.ndarray, image_rows_full: int,
                     image_cols: int, ang_start_y: float, ang_res_y: float,
                     ang_res_x: float, max_range: float,
                     min_range: float) -> np.ndarray:
    """Project a point cloud to a (H, W, 2) range+intensity image
    (reference: sample_kitti_dataset.py:24-65)."""
    x, y, z = points_array[:, 0], points_array[:, 1], points_array[:, 2]
    intensity = points_array[:, 3].copy()

    vertical_angle = np.arctan2(z, np.sqrt(x * x + y * y)) * 180.0 / np.pi
    row_id = np.int_(np.round((vertical_angle + ang_start_y) / ang_res_y))

    horizontal_angle = np.arctan2(x, y) * 180.0 / np.pi
    col_id = -np.int_((horizontal_angle - 90.0) / ang_res_x) + image_cols / 2
    col_id = np.where(col_id >= image_cols, col_id - image_cols, col_id)
    col_id = col_id.astype(np.int64)

    this_range = np.sqrt(x * x + y * y + z * z)
    out_of_range = (this_range > max_range) | (this_range < min_range)
    this_range = np.where(out_of_range, 0.0, this_range)
    intensity = np.where(out_of_range, 0.0, intensity)

    valid = (row_id >= 0) & (row_id < image_rows_full) & \
            (col_id >= 0) & (col_id < image_cols)

    range_image = np.zeros((image_rows_full, image_cols, 1), dtype=np.float32)
    intensity_map = np.zeros((image_rows_full, image_cols, 1), dtype=np.float32)
    range_image[row_id[valid], col_id[valid], 0] = this_range[valid]
    intensity_map[row_id[valid], col_id[valid], 0] = intensity[valid]
    return np.concatenate((range_image, intensity_map), axis=-1)
