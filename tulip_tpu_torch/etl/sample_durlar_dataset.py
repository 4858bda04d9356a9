"""DurLAR dataset sampler:

    python3 -m tulip_tpu_torch.etl.sample_durlar_dataset --input_path ./DurLAR/ \
        --output_path_name_train train --output_path_name_val val \
        --train_data_per_frame 4 --test_data_per_frame 10 --create_val

(the flags of bash_scripts/create_durlar_dataset.sh).  Reads the
``<drive>/ouster_points/data/*.bin`` scans of the four train drives and the
test drive, keeps every Nth (the train / test skip rates), projects each
(etl/durlar.pcd_to_img) and writes ``{:08d}.npy`` (rows, cols, 2) float32
range + intensity maps into ``<parent of --input_path>/<name>``.  The same
flags, drive split, skip rates and file names as
durlar_utils/sample_durlar_dataset.py; an offline host conversion, no
device.
"""

import argparse
import os
import pathlib
from glob import glob

import numpy as np

from tulip_tpu_torch.etl.durlar import pcd_to_img

TRAIN_DATA_FOLDERS = ['DurLAR_20210716', 'DurLAR_20211012',
                      'DurLAR_20211208', 'DurLAR_20210901']
TEST_DATA_FOLDERS = ['DurLAR_20211209']


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=128)
    parser.add_argument("--cols", type=int, default=2048)
    parser.add_argument("--max_range", type=int, default=128)
    parser.add_argument('--range', nargs="+", type=int,
                        help='start and end frame number')
    parser.add_argument("--input_path", type=str, default=None)
    parser.add_argument("--train_data_per_frame", type=int, default=4)
    parser.add_argument("--test_data_per_frame", type=int, default=10)
    parser.add_argument("--output_path_name_train", type=str, default="durlar_train")
    parser.add_argument("--output_path_name_val", type=str, default="durlar_val")
    parser.add_argument("--create_val", action='store_true', default=False)
    return parser.parse_args(argv)


def _collect(folders, input_path):
    data = []
    for folder in folders:
        files = glob(os.path.join(input_path, folder, "ouster_points/data/*.bin"))
        files.sort()
        data.extend(files)
    return data


def _convert(paths, skip, out_dir, rows, cols):
    for i, path in enumerate(paths):
        if i % skip != 0:
            continue
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        range_map, intensity = pcd_to_img(scan, rows=rows, cols=cols)
        out = np.concatenate((range_map[..., None], intensity[..., None]),
                             axis=-1)
        np.save(os.path.join(out_dir, '{:08d}.npy'.format(i)),
                out.astype(np.float32))


def main(args):
    dir_name = os.path.dirname(args.input_path)
    out_train = os.path.join(dir_name, args.output_path_name_train)
    pathlib.Path(out_train).mkdir(parents=True, exist_ok=True)
    if args.create_val:
        out_val = os.path.join(dir_name, args.output_path_name_val)
        pathlib.Path(out_val).mkdir(parents=True, exist_ok=True)

    train_data = _collect(TRAIN_DATA_FOLDERS, args.input_path)
    test_data = _collect(TEST_DATA_FOLDERS, args.input_path)
    print("There are totally {} data for training, we skip with rate {}"
          .format(len(train_data), args.train_data_per_frame))
    print("There are totally {} data for testing, we skip with rate {}"
          .format(len(test_data), args.test_data_per_frame))

    _convert(train_data, args.train_data_per_frame, out_train,
             args.rows, args.cols)
    print("Training Data saved!")
    if args.create_val:
        _convert(test_data, args.test_data_per_frame, out_val,
                 args.rows, args.cols)
        print("Test Data saved!")


if __name__ == "__main__":
    main(read_args())
