"""The port's eval path (tulip_tpu_torch.eval) against the JAX package on
the CPU: projections, voxel counts, the per-sample stats vector, and the
evaluate / MCdrop engines driven by one stand-in forward.

Tolerances:
- projections: fp32 trigonometry in two libraries, <= 1e-5 relative to the
  cloud's extent (a few ulps at 120 m); against the float64 numpy host
  versions <= 1e-4 m (fp32 angle tables).
- chamfer / mae: <= 1e-4 relative.  Both sides are exact nearest-neighbour
  minima, but JAX's expansion-form distances carry ~1e-3 m^2 absolute error
  at these coordinates while the port's direct form does not.
- voxel counts and ratios: fp32 index math on both sides; a point whose
  fp32 coordinate differs by an ulp can flip across a 0.1 m cell edge, so
  ratios may differ by <= 1e-3 (BASELINE.md:51-55) and counts by a few.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tulip_tpu.eval import engine as JE
from tulip_tpu.eval import geometry as JG
from tulip_tpu.eval import metrics as JM
from tulip_tpu.utils.writer import TBWriter as JWriter
from tulip_tpu_torch.eval import engine as TE
from tulip_tpu_torch.eval import geometry as TG
from tulip_tpu_torch.eval import metrics as TM
from tulip_tpu_torch.utils.writer import TBWriter

CPU = torch.device("cpu")
_KEEP = []   # stand-in forwards stay alive: the JAX engine caches by id()


def _image(rng, rows, cols):
    """A scene-like normalized range image: per-row base range + jitter."""
    base = rng.uniform(0.05, 0.6, (rows, 1))
    return np.clip(base + rng.uniform(-0.02, 0.02, (rows, cols)), 0.01,
                   0.99).astype(np.float32)


@pytest.mark.parametrize("dataset,shape", [("carla", (64, 256)),
                                           ("durlar", (128, 256)),
                                           ("kitti", (64, 1024))])
def test_projection_matches_jax_and_numpy(dataset, shape):
    img = _image(np.random.default_rng(0), *shape)
    fns = {"carla": (TG.img_to_pcd_carla_torch, JG.img_to_pcd_carla_jnp,
                     JG.img_to_pcd_carla, 80),
           "durlar": (TG.img_to_pcd_durlar_torch, JG.img_to_pcd_durlar_jnp,
                      JG.img_to_pcd_durlar, 120),
           "kitti": (TG.img_to_pcd_kitti_torch, JG.img_to_pcd_kitti_jnp,
                     JG.img_to_pcd_kitti, 80)}
    ours, jfn, npfn, maxr = fns[dataset]
    pts = ours(torch.from_numpy(img), maximum_range=maxr).numpy()
    ref = np.asarray(jfn(jnp.asarray(img), maximum_range=maxr))
    host = npfn(img.astype(np.float64), maximum_range=maxr)
    assert pts.shape == ref.shape == host.shape == (img.size, 3)
    # which of the three moved, should a limit fail: the pairwise gaps, and
    # what this process could have inherited from a test before it
    gaps = {"pts-ref": float(np.abs(pts - ref).max()),
            "pts-host": float(np.abs(pts - host).max()),
            "ref-host": float(np.abs(ref - host).max())}
    # where pts is farthest from host, how many entries are past the limit,
    # and whether a second evaluation of the port's function repeats it
    worst = np.unravel_index(np.abs(pts - host).argmax(), pts.shape)
    again = ours(torch.from_numpy(img), maximum_range=maxr).numpy()
    where = (f"max gaps in m {gaps}, max|ref| {float(np.abs(ref).max())}, "
             f"worst at point {worst[0]} axis {worst[1]}: pts "
             f"{float(pts[worst])!r} ref {float(ref[worst])!r} host "
             f"{float(host[worst])!r}, {int((np.abs(pts - host) > 1e-4).sum())}"
             f" of {pts.size} entries past 1e-4, a second evaluation "
             f"{'repeats' if np.array_equal(again, pts) else 'differs from'} "
             f"the first (its gap to host "
             f"{float(np.abs(again - host).max())}), "
             f"dtypes pts {pts.dtype} ref {ref.dtype} host {host.dtype}, "
             f"torch threads {torch.get_num_threads()}, "
             f"RANK={os.environ.get('RANK')} "
             f"WORLD_SIZE={os.environ.get('WORLD_SIZE')}")
    assert gaps["pts-ref"] <= 1e-5 * np.abs(ref).max(), where
    assert gaps["pts-host"] <= 1e-4, where


@pytest.mark.parametrize("dataset,shape,maxr", [("carla", (64, 256), 80),
                                                ("kitti", (64, 1024), 80)])
def test_device_voxel_counts_match_jax(dataset, shape, maxr):
    rng = np.random.default_rng(1)
    proj_t = (TG.img_to_pcd_carla_torch if dataset == "carla"
              else TG.img_to_pcd_kitti_torch)
    pred = proj_t(torch.from_numpy(_image(rng, *shape)), maximum_range=maxr)
    gt = proj_t(torch.from_numpy(_image(rng, *shape)), maximum_range=maxr)
    # half the gt points equal pred points, so tp is far from 0
    gt[::2] = pred[::2]
    ours = [int(v) for v in TM.device_voxel_counts(pred, gt, 0.1)]
    ref = [int(v) for v in JM.device_voxel_counts(
        jnp.asarray(pred.numpy()), jnp.asarray(gt.numpy()), 0.1)]
    assert ours == ref     # the same fp32 inputs: no boundary can flip
    p64, g64 = pred.numpy().astype(np.float64), gt.numpy().astype(np.float64)
    both = np.vstack([p64, g64])
    iou, prec, rec = JM.voxel_metrics_sparse(p64, g64, 0.1, both.min(0),
                                             both.max(0))
    n_pred, n_gt, tp = ours
    assert abs(tp / (n_pred + n_gt - tp) - iou) <= 1e-3
    assert abs(tp / n_pred - prec) <= 1e-3 and abs(tp / n_gt - rec) <= 1e-3


class _Args:
    keep_close_scan = False
    save_pcd = False
    grid_size = 0.1
    num_mcdropout_iterations = 10
    noise_threshold = 0.0005
    seed = 0
    log_transform = True

    def __init__(self, dataset, low, high, outdir="."):
        self.dataset_select = dataset
        self.img_size_low_res = low
        self.img_size_high_res = high
        self.output_dir = outdir


@pytest.mark.parametrize("dataset,low,high,keep_close", [
    ("carla", (16, 256), (64, 256), False),
    ("durlar", (32, 128), (128, 128), True)])
def test_device_stats_vector_matches_jax(dataset, low, high, keep_close):
    """[loss_low, chamfer, n_pred, n_gt, tp, mae] of one sample."""
    rng = np.random.default_rng(2)
    args = _Args(dataset, low, high)
    args.keep_close_scan = keep_close
    h = _image(rng, *high)[None, None]
    p = np.clip(h + rng.normal(0, 0.01, h.shape), 0, 1).astype(np.float32)
    lo = h[:, :, ::high[0] // low[0]] + np.float32(0.003)
    ours = TE._make_device_metrics(dataset, args, mc=False)(
        torch.from_numpy(p), torch.from_numpy(h), torch.from_numpy(lo))
    ref = JE._make_device_metrics(dataset, args, mc=False)(
        jnp.asarray(p), jnp.asarray(h), jnp.asarray(lo))
    s, r = ours["stats"].numpy(), np.asarray(ref["stats"])
    np.testing.assert_allclose(s[[0, 1, 5]], r[[0, 1, 5]], rtol=1e-4)
    assert np.abs(s[2:5] - r[2:5]).max() <= 1e-3 * r[2:5].max()
    np.testing.assert_array_equal(ours["pred_inj"].numpy(),
                                  np.asarray(ref["pred_inj"]))


class _Loader:
    def __init__(self, low, high, n=2, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            hi = _image(rng, *high)[None, None]
            lo = np.ascontiguousarray(hi[:, :, ::high[0] // low[0]])
            self.items.append(({'sample': lo}, {'sample': hi}))

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)


def _stand_ins(low, high, seed=3):
    """One forward written twice: nearest-row upsampling plus a fixed
    perturbation, in jnp (for the JAX engines) and torch (for the port)."""
    f = high[0] // low[0]
    noise = np.random.default_rng(seed).normal(
        0, 0.02, (1, 1, *high)).astype(np.float32)
    nj, nt = jnp.asarray(noise), torch.from_numpy(noise)

    def jax_fwd(params, x, rng=None):
        return jnp.repeat(x, f, axis=2) + nj

    def torch_fwd(x):
        return torch.repeat_interleave(x, f, dim=2) + nt

    _KEEP.append(jax_fwd)
    return jax_fwd, torch_fwd


_NO_DROPOUT = types.SimpleNamespace(
    cfg=types.SimpleNamespace(drop_rate=0.0, attn_drop_rate=0.0))


def _compare(ours, ref):
    assert len(ours["mae"]) == len(ref["mae"]) > 0
    for k in ("mae", "chamfer_dist"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("iou", "precision", "recall", "f1"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-3, err_msg=k)


@pytest.mark.parametrize("engine", ["evaluate", "MCdrop"])
@pytest.mark.parametrize("dataset,low,high", [
    ("carla", (16, 128), (64, 128)), ("durlar", (32, 64), (128, 64))])
def test_engine_matches_jax(tmp_path, engine, dataset, low, high):
    """Both engines, one stand-in forward, per-sample results*.txt."""
    jfwd, tfwd = _stand_ins(low, high)
    loader = _Loader(low, high)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jargs = _Args(dataset, low, high, str(jdir))
    targs = _Args(dataset, low, high, str(tdir))
    getattr(JE, engine)(loader, None, _NO_DROPOUT, JWriter(str(jdir / "tb")),
                        args=jargs, sp_forward=jfwd)
    getattr(TE, engine)(loader, _NO_DROPOUT, TBWriter(str(tdir / "tb")),
                        args=targs, device=CPU, sp_forward=tfwd)
    name = "results.txt" if engine == "evaluate" else "results_mcdrop.txt"
    ref = json.load(open(jdir / name))
    ours = json.load(open(tdir / name))
    assert sorted(ours) == sorted(ref)
    _compare(ours, ref)


def test_mc_shortcut_equals_full_loop(tmp_path, monkeypatch):
    low, high = (32, 64), (128, 64)
    _, tfwd = _stand_ins(low, high)
    args = _Args("durlar", low, high, str(tmp_path))
    writer = TBWriter(str(tmp_path / "tb"))
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return tfwd(x)

    fast = TE.MCdrop(_Loader(low, high), _NO_DROPOUT, writer, args=args,
                     device=CPU, sp_forward=counted)
    assert calls == [1, 1]                  # one forward per sample
    monkeypatch.setenv("TULIP_TPU_MC_FULL", "1")
    calls.clear()
    full = TE.MCdrop(_Loader(low, high), _NO_DROPOUT, writer, args=args,
                     device=CPU, sp_forward=counted)
    assert calls == [8] * 4                 # ceil(10 / 8) tiles per sample
    for k in fast:
        # identical passes: mean/std of 10 equal values vs a broadcast
        np.testing.assert_allclose(fast[k], full[k], rtol=1e-6, err_msg=k)


def test_host_metrics_path_matches_device_path(tmp_path, monkeypatch):
    low, high = (32, 64), (128, 64)
    _, tfwd = _stand_ins(low, high)
    args = _Args("durlar", low, high, str(tmp_path))
    dev = TE.evaluate(_Loader(low, high), _NO_DROPOUT,
                      TBWriter(str(tmp_path / "tb")), args=args, device=CPU,
                      sp_forward=tfwd)
    monkeypatch.setenv("TULIP_TPU_HOST_METRICS", "1")
    host = TE.evaluate(_Loader(low, high), _NO_DROPOUT,
                       TBWriter(str(tmp_path / "tb")), args=args, device=CPU,
                       sp_forward=tfwd)
    # float64 host projection + np.unique against the fp32 device path
    _compare(dev, host)


def test_metrics_only_with_writer(tmp_path):
    low, high = (32, 64), (128, 64)
    _, tfwd = _stand_ins(low, high)
    args = _Args("durlar", low, high, str(tmp_path))
    out = TE.evaluate(_Loader(low, high), _NO_DROPOUT, None, args=args,
                      device=CPU, sp_forward=tfwd)
    assert out["mae"] == [] and os.path.exists(tmp_path / "results.txt")


def test_gates_match_jax():
    assert TE._GATES == JE._GATES and TE._GATES_MC == JE._GATES_MC


def test_evaluate_real_tulip(tmp_path):
    """The port's evaluate with the real small TULIP (the 16x256 config of
    tests/test_eval_engine.py) and its own seeded init."""
    from tulip_tpu_torch.models.tulip import init_params, tulip_base
    model = tulip_base(img_size=(16, 256), target_img_size=(64, 256),
                       patch_size=(1, 4), window_size=(2, 8),
                       pixel_shuffle=True, circular_padding=True,
                       log_transform=True, patch_unmerging=True)
    model.load_state_dict(init_params(model.cfg,
                                      torch.Generator().manual_seed(0)))
    args = _Args("carla", (16, 256), (64, 256), str(tmp_path))
    out = TE.evaluate(_Loader((16, 256), (64, 256)), model,
                      TBWriter(str(tmp_path / "tb")), args=args, device=CPU)
    res = json.load(open(tmp_path / "results.txt"))
    assert res == json.loads(json.dumps(out)) and len(res["mae"]) == 2
    assert all(np.isfinite(v) for v in res["chamfer_dist"] + res["mae"])
    assert all(0 <= v <= 1 for v in res["iou"])


def test_eval_imports_no_jax():
    """With jax, jaxlib, optax and the JAX package made unimportable, every
    module of the port still imports (the card's machine has none of
    them)."""
    code = ("import importlib, pkgutil, sys\n"
            "for k in ('jax', 'jaxlib', 'optax', 'tulip_tpu'):\n"
            "    sys.modules[k] = None\n"
            "import tulip_tpu_torch\n"
            "for m in pkgutil.walk_packages(tulip_tpu_torch.__path__, "
            "'tulip_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the numpy host helpers are copies of the JAX package's: held equal
# ---------------------------------------------------------------------------

def test_geometry_constants_equal_the_originals():
    for name in ("OS1_128_OFFSET_LUT", "OS1_128_AZIMUTH_LUT",
                 "OS1_128_ELEVATION_LUT"):
        np.testing.assert_array_equal(getattr(TG, name), getattr(JG, name))
    for name in ("ORIGIN_OFFSET", "LIDAR_TO_SENSOR_Z_OFFSET", "ANGLE_OFF"):
        assert getattr(TG, name) == getattr(JG, name)
    assert TM._PAD_VALUE == JM._PAD_VALUE


@pytest.mark.parametrize("fn,shape,kw", [
    ("img_to_pcd_carla", (64, 256), {}),
    ("img_to_pcd_carla", (16, 128), {"maximum_range": 100}),
    ("img_to_pcd_durlar", (128, 256), {}),
    ("img_to_pcd_kitti", (64, 1024), {"maximum_range": 80}),
    ("img_to_pcd_kitti", (16, 1024), {"low_res": True}),
])
def test_host_projection_equals_the_original(fn, shape, kw):
    img = _image(np.random.default_rng(4), *shape)
    np.testing.assert_array_equal(getattr(TG, fn)(img, **kw),
                                  getattr(JG, fn)(img, **kw))


def test_host_kitti_projection_with_intensity():
    rng = np.random.default_rng(5)
    img, inten = _image(rng, 64, 1024), _image(rng, 64, 1024)
    np.testing.assert_array_equal(TG.img_to_pcd_kitti(img, intensity=inten),
                                  JG.img_to_pcd_kitti(img, intensity=inten))


def test_host_metrics_equal_the_originals():
    rng = np.random.default_rng(6)
    pred = rng.uniform(-20, 20, (4000, 3))
    gt = pred + rng.normal(0, 0.08, pred.shape)
    both = np.vstack([pred, gt])
    lo, hi = both.min(0), both.max(0)
    assert TM.voxel_metrics_sparse(pred, gt, 0.1, lo, hi) == \
        JM.voxel_metrics_sparse(pred, gt, 0.1, lo, hi)
    vp, vg = (TM.voxelize_point_cloud(p, 0.5, lo, hi) for p in (pred, gt))
    np.testing.assert_array_equal(vp, JM.voxelize_point_cloud(pred, 0.5, lo, hi))
    assert TM.calculate_metrics(vp, vg) == JM.calculate_metrics(vp, vg)
    empty = np.zeros((0, 3))
    assert all(np.isnan(v) for v in
               TM.voxel_metrics_sparse(empty, empty, 0.1, lo, hi))
    a, b = rng.normal(size=(2, 1, 8, 16)), rng.normal(size=(2, 1, 8, 16))
    assert TM.mean_absolute_error(a, b) == JM.mean_absolute_error(a, b)
    np.testing.assert_array_equal(TM.inverse_huber_loss(a, b),
                                  JM.inverse_huber_loss(a, b))
    imgs = rng.normal(size=(2, 4, 3, 5))
    np.testing.assert_array_equal(TM.depth_wise_unconcate(imgs),
                                  JM.depth_wise_unconcate(imgs))
