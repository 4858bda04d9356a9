"""Observability sinks: TensorBoard writer, optional wandb, PLY export.

A copy of tulip_tpu/utils/writer.py, which is numpy-only but cannot be
imported without jax (tulip_tpu/utils/__init__.py imports the checkpoint
module).

Parity target: the reference's sink trio (SURVEY.md 5.5) — wandb with
sync_tensorboard (main_lidar_upsampling.py:185-200), TensorBoard scalars and
image grids (engine_upsampling.py:285-305), and .ply point-cloud exports via
trimesh (engine:306-327).  wandb/trimesh are optional here: absent packages
degrade to no-ops / a built-in PLY writer with identical file output paths.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class TBWriter:
    """Thin wrapper over tensorboardX (preferred) or torch's SummaryWriter,
    exposing both .logdir and .log_dir spellings."""

    def __init__(self, log_dir: str):
        self.logdir = self.log_dir = log_dir
        self._w = None
        try:
            from tensorboardX import SummaryWriter
            self._w = SummaryWriter(log_dir=log_dir)
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._w = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._w = None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def add_image(self, tag, img, step, dataformats="CHW"):
        if self._w is not None:
            self._w.add_image(tag, img, step, dataformats=dataformats)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()


def init_wandb(args):
    """rank-0 wandb init with sync_tensorboard
    (reference: main_lidar_upsampling.py:185-195).  No-op if wandb missing."""
    try:
        import wandb
    except ImportError:
        return None
    mode = "disabled" if args.wandb_disabled else "online"
    wandb.init(project=args.project_name, entity=args.entity,
               name=args.run_name, mode=mode, sync_tensorboard=True)
    wandb.config.update(args, allow_val_change=True)
    return wandb


def finish_wandb(wandb_mod):
    if wandb_mod is not None:
        wandb_mod.finish()


def write_ply(path: str, vertices: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY point cloud (replaces trimesh.PointCloud
    .export used at engine_upsampling.py:306-327)."""
    n = vertices.shape[0]
    has_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices.astype("<f4")
            rec["rgb"] = np.clip(colors, 0, 255).astype("u1")
            rec.tofile(f)
        else:
            vertices.astype("<f4").tofile(f)


def colorize_range_image(img: np.ndarray, cmap_name: str = "viridis_r") -> np.ndarray:
    """(H, W) [0,1] -> (3, H, W) RGB via matplotlib colormap if available,
    else grayscale (reference uses viridis_r / jet scalar maps,
    engine_upsampling.py:32-37)."""
    img = np.clip(np.nan_to_num(np.asarray(img, dtype=np.float64)), 0.0, 1.0)
    try:
        import matplotlib.cm as cm
        rgba = cm.get_cmap(cmap_name)(img)
        return rgba[..., :3].transpose(2, 0, 1).astype(np.float32)
    except Exception:
        return np.stack([img, img, img]).astype(np.float32)
