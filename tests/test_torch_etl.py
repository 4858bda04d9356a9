"""The port's dataset creation (tulip_tpu_torch/etl) against the JAX
package's: the projections bit for bit on seeded scans, and the DurLAR /
KITTI samplers against durlar_utils/ and kitti_utils/ main() on one small
synthetic tree, file for file and byte for byte (the KITTI draws seeded
alike in np.random and random on both sides)."""

import filecmp
import importlib.util
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from tulip_tpu.etl import durlar as JDUR, kitti as JKIT
from tulip_tpu.eval.geometry import img_to_pcd_durlar as jax_img_to_pcd
from tulip_tpu_torch import etl as TE
from tulip_tpu_torch.etl import bin_to_img as TBIN
from tulip_tpu_torch.etl import sample_durlar_dataset as TSD
from tulip_tpu_torch.etl import sample_kitti_dataset as TSK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(rel):
    """A dataset-creation script of the JAX package, as a module."""
    name = "jax_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _durlar_scan(rng, rows, cols):
    """x, y, z, intensity of rows * cols returns in the OS1-128's order."""
    r = rng.uniform(0.5, 110.0, rows * cols)
    az = rng.uniform(-np.pi, np.pi, rows * cols)
    el = rng.uniform(np.deg2rad(-21), np.deg2rad(21), rows * cols)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                     r * np.sin(el), rng.uniform(0, 1, rows * cols)],
                    -1).astype(np.float32)


def _kitti_points(rng, n):
    pts = np.zeros((n, 4), np.float32)
    r = rng.uniform(0.5, 130, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.deg2rad(-26), np.deg2rad(4.0), n)
    pts[:, 0] = r * np.cos(el) * np.sin(az)
    pts[:, 1] = r * np.cos(el) * np.cos(az)
    pts[:, 2] = r * np.sin(el)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.mark.parametrize("seed", [0, 1])
def test_pcd_to_img(seed):
    scan = _durlar_scan(np.random.default_rng(seed), 128, 256)
    ours = TE.pcd_to_img(scan, rows=128, cols=256)
    ref = JDUR.pcd_to_img(scan, rows=128, cols=256)
    for o, r in zip(ours, ref):
        assert o.shape == (128, 256) and o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("max_range,min_range", [(120, 0), (80, 2)])
def test_create_range_map(max_range, min_range):
    pts = _kitti_points(np.random.default_rng(2), 20000)
    kw = dict(image_rows_full=64, image_cols=1024, ang_start_y=24.8,
              ang_res_y=26.8 / 63, ang_res_x=360 / 1024,
              max_range=max_range, min_range=min_range)
    ours = TE.create_range_map(pts.copy(), **kw)
    ref = JKIT.create_range_map(pts.copy(), **kw)
    assert ours.shape == (64, 1024, 2) and ours.dtype == np.float32
    assert (ours[..., 0] > 0).sum() > 5000
    np.testing.assert_array_equal(ours, ref)


def test_load_from_bin(tmp_path):
    pts = _kitti_points(np.random.default_rng(3), 1000)
    path = str(tmp_path / "scan.bin")
    pts.tofile(path)
    np.testing.assert_array_equal(TE.load_from_bin(path),
                                  JKIT.load_from_bin(path))
    np.testing.assert_array_equal(TE.load_from_bin(path), pts)


def test_bin_to_img_reports_the_jax_reprojection_error(tmp_path, capsys):
    rows, cols = 128, 256
    scan = _durlar_scan(np.random.default_rng(4), rows, cols)
    path = str(tmp_path / "scan.bin")
    scan.tofile(path)
    TBIN.main(TBIN.read_args([path, "--rows", str(rows), "--cols",
                              str(cols)]))
    out = capsys.readouterr().out.splitlines()
    img, _ = JDUR.pcd_to_img(scan, rows=rows, cols=cols)
    pts = jax_img_to_pcd(img / 120.0, maximum_range=120)
    raw = scan[:, :3]
    diff = np.sqrt(((pts - raw) ** 2).sum(-1))
    mask = np.sqrt((raw ** 2).sum(-1)) > 0.1
    assert out[1] == f"avg_err {diff[mask].mean()}"
    assert out[2] == f"max_diff {diff[mask].max()}"


DURLAR_DRIVES = ['DurLAR_20210716', 'DurLAR_20211012', 'DurLAR_20211208',
                 'DurLAR_20210901', 'DurLAR_20211209']


@pytest.fixture(scope="module")
def durlar_tree(tmp_path_factory):
    """Raw DurLAR: <drive>/ouster_points/data/*.bin, 128 x 64 returns."""
    root = tmp_path_factory.mktemp("durlar_raw") / "DurLAR"
    rng = np.random.default_rng(5)
    for drive, n in zip(DURLAR_DRIVES, (5, 3, 6, 4, 11)):
        d = root / drive / "ouster_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            _durlar_scan(rng, 128, 64).tofile(str(d / f"{i:010d}.bin"))
    return root


def _same_tree(a, b, n):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == n
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors


def _durlar_flags(root, tag, train_skip="4", test_skip="10"):
    # bash_scripts/create_durlar_dataset.sh, at 64 columns
    return ["--input_path", f"{root}/", "--output_path_name_train",
            f"{tag}_train", "--output_path_name_val", f"{tag}_val",
            "--train_data_per_frame", train_skip, "--test_data_per_frame",
            test_skip, "--create_val", "--cols", "64"]


@pytest.mark.parametrize("skips", [("4", "10"), ("1", "3")])
def test_durlar_sampler_equals_jax(durlar_tree, skips):
    jax_main = _script("durlar_utils/sample_durlar_dataset.py")
    tag = "skip" + "_".join(skips)
    jax_main.main(_parse(jax_main,
                         _durlar_flags(durlar_tree, "jax" + tag, *skips)))
    TSD.main(TSD.read_args(_durlar_flags(durlar_tree, "port" + tag, *skips)))
    # 18 train scans, 11 test scans
    n_train = len(range(0, 18, int(skips[0])))
    n_val = len(range(0, 11, int(skips[1])))
    for split, n in (("train", n_train), ("val", n_val)):
        _same_tree(str(durlar_tree / f"jax{tag}_{split}"),
                   str(durlar_tree / f"port{tag}_{split}"), n)
    arr = np.load(str(durlar_tree / f"port{tag}_train" / "00000000.npy"))
    assert arr.shape == (128, 64, 2) and arr.dtype == np.float32


def _parse(module, argv):
    """read_args() of a script that parses sys.argv."""
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        return module.read_args()
    finally:
        sys.argv = saved


def test_durlar_sampler_as_a_module(durlar_tree):
    """python3 -m tulip_tpu_torch.etl.sample_durlar_dataset, as
    create_durlar_dataset.sh runs its script."""
    jax_main = _script("durlar_utils/sample_durlar_dataset.py")
    jax_main.main(_parse(jax_main, _durlar_flags(durlar_tree, "jaxm")))
    proc = subprocess.run(
        [sys.executable, "-m", "tulip_tpu_torch.etl.sample_durlar_dataset",
         *_durlar_flags(durlar_tree, "portm")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "There are totally 18 data for training" in proc.stdout
    assert "Test Data saved!" in proc.stdout
    _same_tree(str(durlar_tree / "jaxm_train"), str(durlar_tree / "portm_train"), 5)
    _same_tree(str(durlar_tree / "jaxm_val"), str(durlar_tree / "portm_val"), 2)


KITTI_DRIVES = ["2011_09_26/2011_09_26_drive_0001_sync",
                "2011_09_26/2011_09_26_drive_0002_sync",
                "2011_09_28/2011_09_28_drive_0016_sync",
                "2011_09_30/2011_09_30_drive_0018_sync",
                "2011_10_03/2011_10_03_drive_0027_sync"]


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Raw KITTI: <date>/<drive>/velodyne_points/data/*.bin, and split
    lists of three train and two val drives."""
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.default_rng(6)
    for drive, n in zip(KITTI_DRIVES, (4, 3, 5, 3, 4)):
        d = root / "KITTI" / drive / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            _kitti_points(rng, 3000).tofile(str(d / f"{i:010d}.bin"))
    (root / "train.txt").write_text("\n".join(KITTI_DRIVES[:3]) + "\n")
    (root / "val.txt").write_text("\n".join(KITTI_DRIVES[3:]) + "\n")
    return root


def _kitti_flags(root, tag, n_train, n_val, splits=True):
    # bash_scripts/create_kitti_dataset.sh, with a small count
    flags = ["--num_data_train", str(n_train), "--num_data_val", str(n_val),
             "--output_path_name_train", f"{tag}_train",
             "--output_path_name_val", f"{tag}_val",
             "--input_path", f"{root}/KITTI/", "--create_val"]
    if splits:
        flags += ["--train_split", f"{root}/train.txt",
                  "--val_split", f"{root}/val.txt"]
    else:
        flags += ["--train_split", f"{root}/none.txt",
                  "--val_split", f"{root}/none.txt"]
    return flags


def _seeded(seed, fn):
    np.random.seed(seed)
    random.seed(seed)
    fn()


@pytest.mark.parametrize("n_train,n_val,splits", [
    (2, 1, True),     # fewer scans than drives: one drive each, drawn
    (7, 5, True),     # more: several scans a drive
    (6, 4, False),    # no split list: the drives found under the input
])
def test_kitti_sampler_equals_jax(kitti_tree, n_train, n_val, splits):
    jax_main = _script("kitti_utils/sample_kitti_dataset.py")
    tag = f"n{n_train}_{n_val}_{int(splits)}"
    _seeded(11, lambda: jax_main.main(_parse(
        jax_main, _kitti_flags(kitti_tree, "jax" + tag, n_train, n_val,
                               splits))))
    _seeded(11, lambda: TSK.main(TSK.read_args(
        _kitti_flags(kitti_tree, "port" + tag, n_train, n_val, splits))))
    out = kitti_tree / "KITTI"
    _same_tree(str(out / f"jax{tag}_train"), str(out / f"port{tag}_train"),
               n_train)
    _same_tree(str(out / f"jax{tag}_val"), str(out / f"port{tag}_val"), n_val)
    arr = np.load(str(out / f"port{tag}_train" / "00000000.npy"))
    assert arr.shape == (64, 1024, 2) and (arr[..., 0] > 0).any()


def test_kitti_default_split_lists_are_the_repositorys():
    assert TSK.SPLIT_DIR == os.path.join(REPO, "kitti_utils")
    args = TSK.read_args([])
    assert args.train_split is None and args.val_split is None
    split = TSK._load_split(None, "val_files.txt", "/nonexistent")
    with open(os.path.join(REPO, "kitti_utils", "val_files.txt")) as f:
        assert list(split) == f.read().splitlines()


def test_kitti_sampler_short_of_scans_raises(kitti_tree):
    args = TSK.read_args(_kitti_flags(kitti_tree, "short", 40, 1))
    with pytest.raises(ValueError, match="sampled 12 scans, asked for 40"):
        _seeded(0, lambda: TSK.main(args))
