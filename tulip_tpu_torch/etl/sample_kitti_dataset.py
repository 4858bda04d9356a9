"""KITTI dataset sampler:

    python3 -m tulip_tpu_torch.etl.sample_kitti_dataset --num_data_train 20000 \
        --num_data_val 2500 --output_path_name_train train \
        --output_path_name_val val --input_path ./KITTI/ --create_val

(the flags of bash_scripts/create_kitti_dataset.sh).  Draws scans from the
drives of the split lists (one random scan per drive, or more where the
list is shorter than the count), projects each (etl/kitti.create_range_map)
and writes ``{:08d}.npy`` 64 x 1024 x 2 float32 range + intensity maps into
``<parent of --input_path>/<name>``.  The same flags, directory
conventions, draws (``np.random`` and ``random``: seed both for a
repeatable tree) and file names as kitti_utils/sample_kitti_dataset.py; an
offline host conversion, no device.

The split lists are data files: by default the repository's
``kitti_utils/train_files.txt`` / ``val_files.txt`` (one
``<date>/<drive>`` a line), else ``--train_split`` / ``--val_split``; where
the list file does not exist, the drives are discovered under the input
directory (``*/*/velodyne_points/data/*.bin``).
"""

import argparse
import os
import pathlib
import random
from glob import glob

import numpy as np

from tulip_tpu_torch.etl.kitti import create_range_map, load_from_bin

SPLIT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "kitti_utils")


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--num_data_train', type=int, default=21000)
    parser.add_argument('--num_data_val', type=int, default=2500)
    parser.add_argument("--input_path", type=str, default="./KITTI/")
    parser.add_argument("--output_path_name_train", type=str, default="kitti_train")
    parser.add_argument("--output_path_name_val", type=str, default="kitti_val")
    parser.add_argument("--create_val", action='store_true', default=False)
    parser.add_argument("--train_split", type=str, default=None,
                        help="path to the train drive list (default: "
                             "kitti_utils/train_files.txt of the repository)")
    parser.add_argument("--val_split", type=str, default=None,
                        help="path to the val drive list (default: "
                             "kitti_utils/val_files.txt of the repository)")
    return parser.parse_args(argv)


def readlines(filename):
    with open(filename, 'r') as f:
        return f.read().splitlines()


def _load_split(explicit_path, default_name, input_dir):
    path = explicit_path or os.path.join(SPLIT_DIR, default_name)
    if os.path.exists(path):
        return np.array(readlines(path), dtype=str)
    print(f"split list {path} not found; discovering drives under {input_dir}")
    drives = sorted({os.path.relpath(os.path.dirname(os.path.dirname(
        os.path.dirname(p))), input_dir)
        for p in glob(os.path.join(input_dir, "*", "*",
                                   "velodyne_points", "data", "*.bin"))})
    return np.array(drives, dtype=str)


def _sample(split, num_data, dir_name):
    """Sample num_data scans: one (or k) random .bin per drive
    (reference behaviour: sample_kitti_dataset.py:100-136)."""
    data = []
    if num_data < len(split):
        split = np.random.choice(split, num_data, replace=False)
        per_drive = 1
    else:
        per_drive = num_data // len(split) + 1
    for folder in split:
        scans = np.array(glob(os.path.join(
            dir_name, folder, "velodyne_points/data/*.bin")))
        if len(scans) == 0:
            continue
        k = min(per_drive, len(scans))
        data += list(np.random.choice(scans, k, replace=False))
    random.shuffle(data)
    data = data[:num_data]
    if len(data) != num_data:
        raise ValueError(f"sampled {len(data)} scans, asked for {num_data}")
    return data


def main(args):
    dir_name = os.path.dirname(args.input_path)
    out_train = os.path.join(dir_name, args.output_path_name_train)
    pathlib.Path(out_train).mkdir(parents=True, exist_ok=True)
    if args.create_val:
        out_val = os.path.join(dir_name, args.output_path_name_val)
        pathlib.Path(out_val).mkdir(parents=True, exist_ok=True)

    train_split = _load_split(args.train_split, "train_files.txt", dir_name)
    val_split = _load_split(args.val_split, "val_files.txt", dir_name)

    train_data = _sample(train_split, args.num_data_train, dir_name)
    val_data = _sample(val_split, args.num_data_val, dir_name) \
        if args.create_val else []

    # projection constants (reference: sample_kitti_dataset.py:139-145)
    image_rows, image_cols = 64, 1024
    ang_start_y = 24.8
    ang_res_y = 26.8 / (image_rows - 1)
    ang_res_x = 360 / image_cols
    max_range, min_range = 120, 0

    for i, path in enumerate(train_data):
        m = create_range_map(load_from_bin(path), image_rows, image_cols,
                             ang_start_y, ang_res_y, ang_res_x,
                             max_range, min_range)
        np.save(os.path.join(out_train, '{:08d}.npy'.format(i)),
                m.astype(np.float32))

    for j, path in enumerate(val_data):
        m = create_range_map(load_from_bin(path), image_rows, image_cols,
                             ang_start_y, ang_res_y, ang_res_x,
                             max_range, min_range)
        np.save(os.path.join(out_val, '{:08d}.npy'.format(j)),
                m.astype(np.float32))


if __name__ == "__main__":
    main(read_args())
