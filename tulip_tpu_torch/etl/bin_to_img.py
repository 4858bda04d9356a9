"""One Ouster .bin scan -> range image, with the reprojection error:

    python3 -m tulip_tpu_torch.etl.bin_to_img SCAN.bin [--rows 128]
        [--cols 2048] [--save_png OUT.png]

Projects the scan (etl/durlar.pcd_to_img), reprojects the range image with
the beam model (eval/geometry.img_to_pcd_durlar) and prints the average and
largest distance of the reprojected points from the scan's; --save_png
writes a preview (needs matplotlib).  The same flags and report as
durlar_utils/bin_to_img.py; an offline host tool, no device.
"""

import argparse

import numpy as np

from tulip_tpu_torch.etl.durlar import pcd_to_img
from tulip_tpu_torch.eval.geometry import img_to_pcd_durlar


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("path")
    parser.add_argument('--rows', nargs='?', default=128, type=int)
    parser.add_argument('--cols', nargs='?', default=2048, type=int)
    parser.add_argument('--save_png', type=str, default=None,
                        help='write the range preview here instead of showing it')
    return parser.parse_args(argv)


def main(args):
    print("Loading PCD from {}".format(args.path), "with shape",
          args.rows, args.cols)
    scan = np.fromfile(args.path, dtype=np.float32).reshape(-1, 4)
    img_range, img_data = pcd_to_img(scan, rows=args.rows, cols=args.cols)

    # reprojection check: the beam model scatters into scan order
    pts = img_to_pcd_durlar(img_range / 120.0, maximum_range=120)
    raw = scan[:args.rows * args.cols, :3]
    diff = np.sqrt(((pts - raw) ** 2).sum(-1))
    mask = np.sqrt((raw ** 2).sum(-1)) > 0.1
    print("avg_err", diff[mask].mean())
    print("max_diff", diff[mask].max())

    if args.save_png:
        try:
            import matplotlib
        except ImportError:
            print("matplotlib unavailable; skipping png export")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(args.save_png, np.clip(img_range / 50.0, 0, 1),
                   cmap="viridis")
        print("saved", args.save_png)


if __name__ == "__main__":
    main(read_args())
