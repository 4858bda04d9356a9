"""Dataset creation: offline host conversions of raw LiDAR scans into the
range-image .npy files the data builders read.  numpy only, no device: the
port's copies of tulip_tpu/etl (run as ``python3 -m
tulip_tpu_torch.etl.sample_durlar_dataset`` / ``sample_kitti_dataset`` /
``bin_to_img``)."""

from .kitti import create_range_map, load_from_bin
from .durlar import pcd_to_img
