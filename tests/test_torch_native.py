"""The port's fused native reader (tulip_tpu_torch/data/native.py and
data/native/loader.cpp) against the JAX package's (tulip_tpu/data/native.py):
both compile the same C, so their reads agree bit for bit; against the
port's numpy loader + transform chain within 1e-7 (C's log1pf against
numpy's float32 log1p).  Then the up-front choice between the two paths,
the errors (no fallback), the build, and the DurLAR / KITTI builders and
loader batches against JAX's."""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import tulip_tpu.data as JD
from tulip_tpu.data import native as JN
import tulip_tpu_torch.data as TD
from tulip_tpu_torch.data import datasets as TDS
from tulip_tpu_torch.data import native as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, spec, the port's numpy chain of the same transform)
CHAINS = {
    "durlar_low": (dict(scale=1 / 120, min_r=0.3 / 120, max_r=1.0,
                        log1p=True, row_stride=4),
                   lambda M: [M.ScaleTensor(1 / 120),
                              M.FilterInvalidPixels(0.3 / 120, 1.0),
                              M.DownsampleTensor(128, 4), M.LogTransform()]),
    "durlar_high": (dict(scale=1 / 120, min_r=0.3 / 120, max_r=1.0,
                         log1p=False),
                    lambda M: [M.ScaleTensor(1 / 120),
                               M.FilterInvalidPixels(0.3 / 120, 1.0)]),
    "kitti_low": (dict(scale=1 / 80, log1p=True, row_stride=4, col_stride=2),
                  lambda M: [M.ScaleTensor(1 / 80), M.DownsampleTensor(128, 4),
                             M.DownsampleTensorWidth(256, 2),
                             M.LogTransform()]),
}


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    # the JAX reader returns None on a failed build and its callers take
    # numpy; every bit-equality below needs its C path
    assert JN.available()
    TN.load()


def _save(path, arr, version=None):
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=version)
    return str(path)


def _scan(rng, shape=(128, 256)):
    """Range (metres, some outside the DurLAR gate) + intensity."""
    return np.stack([rng.uniform(0.1, 130.0, shape),
                     rng.uniform(0, 1, shape)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    out = {}
    for version in ((1, 0), (2, 0)):
        out[version] = [_save(root / f"v{version[0]}_{i}.npy", _scan(rng),
                              version=version) for i in range(8)]
    return out


@pytest.mark.parametrize("version", [(1, 0), (2, 0)], ids=["v1", "v2"])
def test_npy_shape(files, version):
    p = files[version][0]
    assert TN.npy_shape(p) == JN.npy_shape(p) == (128, 256, 2)
    assert TN.native_shape(p) == (128, 256, 2)


@pytest.mark.parametrize("version", [(1, 0), (2, 0)], ids=["v1", "v2"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_read_range_map(files, chain, version):
    spec, steps = CHAINS[chain]
    for p in files[version][:3]:
        ours = TN.read_range_map(p, **spec)
        np.testing.assert_array_equal(ours, JN.read_range_map(p, **spec))
        ref = TD.Compose([TD.ToChannelFirst(), *steps(TD)])(TD.npy_loader(p))
        assert ours[None].shape == ref.shape
        np.testing.assert_allclose(ours[None], ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_read_range_batch(files, chain, threads):
    spec, _ = CHAINS[chain]
    paths = files[(1, 0)] + files[(2, 0)]
    shape = TN.read_range_map(paths[0], **spec).shape
    ours = TN.read_range_batch(paths, out_shape=shape, num_threads=threads,
                               **spec)
    ref = JN.read_range_batch(paths, out_shape=shape, num_threads=threads,
                              **spec)
    assert ours.shape == (16, 1, *shape)
    np.testing.assert_array_equal(ours, ref)
    # the same bits whatever the thread count, and as one file at a time
    np.testing.assert_array_equal(
        ours, TN.read_range_batch(paths, out_shape=shape, num_threads=1,
                                  **spec))
    np.testing.assert_array_equal(
        ours[:, 0], np.stack([TN.read_range_map(p, **spec) for p in paths]))


def test_counts(files):
    spec, _ = CHAINS["durlar_low"]
    TN.reset_counts()
    TN.read_range_batch(files[(1, 0)], out_shape=(32, 256), num_threads=2,
                        **spec)
    TN.read_range_map(files[(1, 0)][0], **spec)
    assert TN.counts == {"batches": 1, "items": 9, "numpy_items": 0}


@pytest.mark.parametrize("kind", ["float64", "fortran", "4d", "float32"])
def test_the_first_header_decides_the_path(tmp_path, kind):
    """A folder reads natively exactly when its first file is what
    loader.cpp reads; otherwise every item takes the numpy chain, with the
    same values as JAX's builder (which falls back item by item)."""
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        d = tmp_path / "durlar" / split
        d.mkdir(parents=True)
        for i in range(3):
            arr = _scan(rng, (128, 64))
            arr = {"float64": arr.astype(np.float64),
                   "fortran": np.asfortranarray(arr),
                   "4d": arr[:, :, None, :],
                   "float32": arr}[kind]
            np.save(str(d / f"{i:05d}.npy"), arr)
    args = types.SimpleNamespace(
        dataset_select="durlar", img_size_low_res=[32, 64],
        img_size_high_res=[128, 64], log_transform=False, roll=False,
        data_path_low_res=str(tmp_path / "durlar"),
        data_path_high_res=str(tmp_path / "durlar"))
    ours = TD.generate_dataset(args, False)
    native = kind == "float32"
    assert ours.native == native
    assert all(d.native == native for d in ours.datasets)
    TN.reset_counts()
    batches = list(TD.DataLoader(ours, batch_size=3, num_workers=1))
    assert TN.counts["numpy_items"] == (0 if native else 6)
    assert TN.counts["batches"] == (2 if native else 0)
    if kind != "4d":   # JAX's reader parses three of its four dims
        ref = JD.generate_dataset(args, False)
        for i in range(3):
            for o, r in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(o["sample"], r["sample"])
    for o, r in zip(batches[0], ours.datasets):
        np.testing.assert_array_equal(
            o["sample"], np.stack([r[i]["sample"] for i in range(3)]))
    if not native:
        with pytest.raises(ValueError, match="numpy chain"):
            ours.datasets[0].read_batch([0])


def test_failed_reads_raise_and_name_the_file(tmp_path):
    rng = np.random.default_rng(2)
    good = [_save(tmp_path / f"{i}.npy", _scan(rng, (32, 64)))
            for i in range(3)]
    bad = str(tmp_path / "truncated.npy")
    with open(good[0], "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[: len(data) // 2])
    spec = dict(scale=1 / 120, min_r=0.3 / 120, max_r=1.0, log1p=True)
    with pytest.raises(OSError, match="truncated.npy"):
        TN.read_range_map(bad, out_shape=(32, 64), **spec)
    with pytest.raises(OSError, match="truncated.npy"):
        TN.read_range_batch(good + [bad], out_shape=(32, 64), num_threads=2,
                            **spec)
    missing = str(tmp_path / "missing.npy")
    with pytest.raises(OSError, match="missing.npy"):
        TN.read_range_map(missing, **spec)
    with pytest.raises(OSError, match="missing.npy"):
        TN.npy_shape(missing)
    # a folder that reads natively raises on its odd file, in a batch and
    # item by item (JAX would fall back to numpy for that item)
    folder = TDS.RangeMapFolder(str(tmp_path), class_dir=False,
                                native_spec=spec)
    assert folder.native
    names = [os.path.basename(p) for p, _ in folder.samples]
    odd = names.index("truncated.npy")
    with pytest.raises(OSError, match="truncated.npy"):
        folder[odd]
    with pytest.raises(OSError, match="truncated.npy"):
        list(TD.DataLoader(TDS.PairDataset(folder), batch_size=4,
                           num_workers=1))


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    return tmp_path


def test_failed_build_raises_with_the_compiler_output(fresh_build,
                                                      monkeypatch):
    cxx = fresh_build / "g++"
    cxx.write_text("#!/bin/sh\necho 'loader.cpp:1: error: no compiler "
                   "today' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(TN, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="no compiler today"):
        TN.load()
    assert not list((fresh_build / "build").iterdir())
    monkeypatch.setattr(TN, "CXX", str(fresh_build / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not start"):
        TN.load()


def test_build_lands_under_its_hash(fresh_build):
    lib = TN.load()
    path = TN.library_path()
    assert path.parent == fresh_build / "build"
    assert path.name.startswith("libtulip_io_") and path.exists()
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert lib is TN.load()


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build into one empty directory at the same moment:
    each writes under its own temporary name and moves it into place, so
    none loads a half-written library."""
    script = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        sys.path.insert(0, {REPO!r})
        from tulip_tpu_torch.data import native
        native.BUILD_DIR = Path({str(tmp_path / "build")!r})
        while time.time() < float(sys.argv[1]):
            time.sleep(0.005)
        native.load()
        print(native.npy_shape(sys.argv[2]))
    """)
    npy = _save(tmp_path / "a.npy", np.zeros((4, 8, 2), np.float32))
    import time
    start = str(time.time() + 2.0)
    procs = [subprocess.Popen([sys.executable, "-c", script, start, npy],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip() == "(4, 8, 2)" for o, _ in outs)
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        TN.library_path().name]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("builders")
    rng = np.random.default_rng(3)
    for name, shape in (("durlar", (128, 64)), ("kitti", (64, 256))):
        for split, n in (("train", 6), ("val", 3)):
            d = root / name / split
            d.mkdir(parents=True)
            for i in range(n):
                np.save(str(d / f"{i:05d}.npy"), _scan(rng, shape))
    return root


BUILDS = [
    ("durlar", (32, 64), (128, 64), True, True, True),
    ("durlar", (32, 64), (128, 64), True, False, True),
    ("durlar", (32, 64), (128, 64), False, True, False),
    ("kitti", (16, 256), (64, 256), True, True, False),
    ("kitti", (16, 128), (64, 256), False, False, False),
]


@pytest.mark.parametrize("name,low,high,is_train,log,roll", BUILDS)
def test_builders_and_loader_equal_jax(folders, name, low, high, is_train,
                                       log, roll):
    """Items, and loader batches (with a W shard), bit-equal to JAX's."""
    args = types.SimpleNamespace(
        dataset_select=name, img_size_low_res=list(low),
        img_size_high_res=list(high), log_transform=log, roll=roll,
        data_path_low_res=str(folders / name),
        data_path_high_res=str(folders / name))
    np.random.seed(5)
    ours = TD.generate_dataset(args, is_train)
    np.random.seed(5)
    ref = JD.generate_dataset(args, is_train)
    assert ours.native and len(ours) == len(ref)
    for i in range(len(ref)):
        for o, r, size in zip(ours[i], ref[i], (low, high)):
            assert o["name"] == r["name"] and o["class"] == r["class"]
            assert o["sample"].shape == (1, *size)
            np.testing.assert_array_equal(o["sample"], r["sample"])
    mk = lambda M, ds, **kw: M.DataLoader(
        ds, batch_size=2, drop_last=True, num_workers=2,
        sampler=M.ShardedSampler(len(ds), shuffle=True, seed=1,
                                 drop_last=True), **kw)
    TN.reset_counts()
    whole = list(mk(TD, ours))
    shard = list(mk(TD, ours, w_shard=(1, 2)))
    refs = list(mk(JD, ref))
    assert len(whole) == len(shard) == len(refs) == len(ref) // 2
    assert TN.counts["numpy_items"] == 0
    assert TN.counts["batches"] == 4 * len(refs)
    for ob, sb, rb in zip(whole, shard, refs):
        for o, s, r in zip(ob, sb, rb):
            assert o["name"] == s["name"] == r["name"]
            np.testing.assert_array_equal(o["class"], r["class"])
            np.testing.assert_array_equal(o["sample"], r["sample"])
            w = r["sample"].shape[-1] // 2
            np.testing.assert_array_equal(s["sample"], r["sample"][..., w:])
