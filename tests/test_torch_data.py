"""The port's data package (tulip_tpu_torch.data) against the JAX package's,
of which it is a numpy-only copy without the fused native reader: loaders,
transforms, the three dataset builders on small synthetic folders, the
sampler's order per epoch and the loader's batches.  Equality is exact
where both sides run the same numpy code; the JAX package's native DurLAR /
KITTI reader computes log1p in C, within 1e-6 of numpy's."""

import os
import types

import numpy as np
import pytest

from tulip_tpu import data as JD
from tulip_tpu.data import datasets as JDS
from tulip_tpu_torch import data as TD
from tulip_tpu_torch.data import datasets as TDS


def _write_rimg(path, img):
    H, W = img.shape
    payload = np.flip(img).astype(np.float16).T
    with open(path, "wb") as f:
        np.array([H, W], dtype=np.uint64).tofile(f)
        payload.tofile(f)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for town in ["Town01", "Town02", "Town03", "Town04", "Town05", "Town06",
                 "Town07", "Town10HD"]:
        for res, shape in (("16_64", (16, 64)), ("64_64", (64, 64))):
            d = root / "carla" / town / res
            d.mkdir(parents=True)
            for i in range(2):
                _write_rimg(str(d / f"{i:04d}.rimg"),
                            rng.uniform(0.5, 90.0, shape).astype(np.float32))
    for name, shape in (("durlar", (128, 64)), ("kitti", (64, 1024))):
        for split, n in (("train", 5), ("val", 2)):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(n):
                arr = np.stack([rng.uniform(0.1, 130.0, shape),
                                rng.uniform(0, 1, shape)], -1)
                np.save(str(d / f"{i:05d}.npy"), arr.astype(np.float32))
    return root


def _args(root, name, low, high, log=True, roll=False):
    return types.SimpleNamespace(
        dataset_select=name, img_size_low_res=list(low),
        img_size_high_res=list(high), log_transform=log, roll=roll,
        data_path_low_res=str(root / name), data_path_high_res=str(root / name))


def test_exports_are_the_same():
    assert set(n for n in dir(JD) if not n.startswith("_")) - {"native"} == \
        set(n for n in dir(TD) if not n.startswith("_"))
    assert set(TDS.dataset_list) == set(JDS.dataset_list) == \
        {"durlar", "kitti", "carla"}


def test_loaders(folders, tmp_path):
    rimg = str(folders / "carla" / "Town01" / "16_64" / "0000.rimg")
    np.testing.assert_array_equal(TD.rimg_loader(rimg), JD.rimg_loader(rimg))
    npy = str(folders / "durlar" / "train" / "00000.npy")
    a, b = TD.npy_loader(npy), JD.npy_loader(npy)
    assert a.dtype == np.float32 and a.shape == (128, 64)
    np.testing.assert_array_equal(a, b)
    raw = np.random.default_rng(1).uniform(0, 80, (64, 1024, 2))
    path = str(tmp_path / "scan.bin")
    raw.astype(np.float32).tofile(path)
    np.testing.assert_array_equal(TD.bin_loader(path), JD.bin_loader(path))


TRANSFORMS = [
    ("ToChannelFirst", ()), ("ScaleTensor", (1 / 120,)),
    ("FilterInvalidPixels", (0.1, 0.9)), ("LogTransform", ()),
    ("DownsampleTensor", (16, 4)), ("DownsampleTensorWidth", (32, 2)),
    ("RandomRollRangeMap", (32, 5)), ("CropRanges", (0.2, 0.8)),
    ("KeepCloseScan", (0.5,)), ("KeepFarScan", (0.5,)),
    ("DepthwiseConcatenation", (16, 4)),
]


@pytest.mark.parametrize("name,ctor", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_transform(name, ctor):
    x = np.random.default_rng(2).uniform(0, 1, (1, 16, 32)).astype(np.float32)
    if name == "ToChannelFirst":
        x = x[0]
    ours, ref = getattr(TD, name)(*ctor)(x), getattr(JD, name)(*ctor)(x)
    if isinstance(ref, tuple):
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, r)
    else:
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_compose_and_noise_and_random_draws():
    x = np.random.default_rng(3).uniform(0, 1, (1, 16, 32)).astype(np.float32)
    chain = lambda M: M.Compose([M.ScaleTensor(0.5), M.LogTransform()])
    np.testing.assert_array_equal(chain(TD)(x), chain(JD)(x))
    for M, out in ((TD, []), (JD, [])):
        np.random.seed(7)
        out.append(M.AddGaussianNoise(0.5, 0.1)(x))
        out.append(M.RandomRollRangeMap(h_img=32).shift)
        out.append(list(M.DownsampleTensor(16, 4, random=True).low_res_index))
        if M is TD:
            ours = out
    np.testing.assert_array_equal(ours[0], out[0])
    assert ours[1:] == out[1:]


@pytest.mark.parametrize("name,low,high,is_train,log", [
    ("carla", (16, 64), (64, 64), True, True),
    ("carla", (16, 64), (64, 64), False, False),
    ("carla", (32, 64), (64, 64), True, True),     # low res made from high
    ("durlar", (32, 64), (128, 64), True, True),
    ("durlar", (32, 64), (128, 64), False, False),
    ("kitti", (16, 1024), (64, 1024), True, True),
    ("kitti", (16, 512), (64, 1024), False, False),
])
def test_dataset_builder(folders, name, low, high, is_train, log):
    args = _args(folders, name, low, high, log=log)
    ours = TD.generate_dataset(args, is_train)
    ref = JD.generate_dataset(args, is_train)
    assert len(ours) == len(ref) > 0
    # the JAX package's fused native reader (durlar, kitti) takes log1p in C
    exact = name == "carla" or not log
    for i in range(len(ref)):
        for o, r, size in zip(ours[i], ref[i], (low, high)):
            assert o["name"] == r["name"] and o["class"] == r["class"]
            assert o["sample"].shape == r["sample"].shape == (1, *size)
            if exact:
                np.testing.assert_array_equal(o["sample"], r["sample"])
            else:
                np.testing.assert_allclose(o["sample"], r["sample"], rtol=0,
                                           atol=1e-6)


def test_durlar_roll_is_shared_by_both_resolutions(folders):
    args = _args(folders, "durlar", (32, 64), (128, 64), roll=True)
    np.random.seed(11)
    ours = TD.generate_dataset(args, True)
    np.random.seed(11)
    ref = JD.generate_dataset(args, True)
    low, high = ours[0]
    rlow, rhigh = ref[0]
    np.testing.assert_allclose(low["sample"], rlow["sample"], atol=1e-6)
    np.testing.assert_allclose(high["sample"], rhigh["sample"], atol=1e-6)
    np.testing.assert_array_equal(low["sample"][0], high["sample"][0, ::4])


def test_folder_errors_and_containers(folders, tmp_path):
    with pytest.raises(FileNotFoundError):
        TDS.RangeMapFolder(str(tmp_path), class_dir=False)
    with pytest.raises(FileNotFoundError):
        TDS.RangeMapFolder(str(tmp_path), class_dir=True)
    d = str(folders / "durlar" / "train")
    a = TDS.RangeMapFolder(d, class_dir=False)
    b = JDS.RangeMapFolder(d, class_dir=False)
    assert a.samples == b.samples and a.classes == b.classes
    cat, rcat = TDS.ConcatDataset([a, a]), JDS.ConcatDataset([b, b])
    assert len(cat) == len(rcat) == 10
    assert cat[-1]["name"] == rcat[-1]["name"] == cat[4]["name"]
    assert len(TDS.PairDataset(a, cat)) == 5


@pytest.mark.parametrize("n,replicas,shuffle,drop_last", [
    (10, 1, True, True), (10, 1, False, False), (10, 4, True, False),
    (10, 4, True, True), (7, 2, False, False)])
def test_sharded_sampler_order_per_epoch(n, replicas, shuffle, drop_last):
    for rank in range(replicas):
        ours = TD.ShardedSampler(n, replicas, rank, shuffle, 3, drop_last)
        ref = JD.ShardedSampler(n, replicas, rank, shuffle, 3, drop_last)
        assert len(ours) == len(ref)
        for epoch in (0, 1, 5):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)


def test_data_loader_batches(folders):
    args = _args(folders, "carla", (16, 64), (64, 64))
    ours_ds, ref_ds = TD.generate_dataset(args, True), JD.generate_dataset(args, True)
    mk = lambda M, ds: M.DataLoader(
        ds, batch_size=5, drop_last=True, num_workers=2,
        sampler=M.ShardedSampler(len(ds), shuffle=True, seed=0, drop_last=True))
    ours, ref = mk(TD, ours_ds), mk(JD, ref_ds)
    assert len(ours) == len(ref) == 2
    for (ol, oh), (rl, rh) in zip(ours, ref):
        assert ol["name"] == rl["name"] and oh["name"] == rh["name"]
        np.testing.assert_array_equal(ol["sample"], rl["sample"])
        np.testing.assert_array_equal(oh["sample"], rh["sample"])
        assert ol["sample"].shape == (5, 1, 16, 64)
    tail = TD.DataLoader(ours_ds, batch_size=5, drop_last=False, num_workers=1)
    assert [b[0]["sample"].shape[0] for b in tail] == [5, 5, 2]


def test_loader_surfaces_worker_errors():
    class Bad:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise OSError("unreadable scan")

    with pytest.raises(OSError, match="unreadable"):
        list(TD.DataLoader(Bad(), batch_size=1, num_workers=1))
