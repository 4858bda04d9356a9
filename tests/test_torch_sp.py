"""W-axis sequence parallel in the port (parallel/{halo,sp,mesh}.py, the
shifted blocks of models/swin.py, the patch embed's pad) on the CPU: gloo
ranks in processes of their own over a FileStore under tmp_path, one
torch thread each, spawned through test_torch_dp.py:run_ranks (a time
limit a rank, the rest killed when one fails: a rank left alone waits in
an exchange for ever).

At the small config of test_torch_dp.py (a two-stage TULIP-base,
16x256 -> 64x256, whose token grids 16x64 and 8x32 take sp 2), fp32:

- exchanges: roll_w / roll_hw / circular_pad_w under 2 and 4 ranks equal
  the single-device op on the joined tensor, and so do their gradients
  (float64, against autograd of the unsharded op), bit for bit;
- statics: the body / last masks equal the JAX package's
  build_sp_statics for every shifted block of the flagship at sp 2 and 4;
  max_sp_degree equals JAX's for the flagship (4) and the small config (2);
- forward: two seq ranks, mode "eval": the joined pred within 1e-5 of the
  port's one-process pred and within test_torch_model.py's 1e-4 of JAX's
  unsharded apply_model;
- MCdrop: eval/engine.py:MCdrop through make_sp_eval_forward on two seq
  ranks against one process: the preds within 1e-5 of max|ref|, the
  results within 1e-5 relative, rank 0 alone writing results_mcdrop.txt;
- step: two seq ranks against one process, drop_path_rate 0.1 with a row
  dropped: the losses within 1e-5 relative, the first update's gradient
  within 1e-5 of each tensor's max|ref|, then the weights and the later
  gradients within test_torch_dp.py's limits, the ranks' weights bit-equal
  after every step; the same ranks at drop-path 0 against the JAX
  package's make_train_step within 1e-4 of each gradient's max and the
  AdamW limits of test_torch_train.py; dp 2 x sp 2 on four ranks against
  one process on the joined batch; in float64, 16 steps at lr 5e-4 on one
  process's weights to 1e-10 of the model's max (over as many fp32 steps
  any two summation orders drift apart, data parallel's too); and ranks
  whose exchange has no
  backward (a halo column's cotangent never returns to its owner) miss
  the one-process gradient by far more than the limit.
"""

import json
import sys

import numpy as np
import pytest
import torch

from test_torch_dp import KW, LR, TESTS, _one_process, _within, run_ranks
from tulip_tpu_torch.config import model_config
from tulip_tpu_torch.data.pipeline import slice_w
from tulip_tpu_torch.models import layers as L
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.parallel import halo
from tulip_tpu_torch.parallel import sp as SP
from tulip_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate
from tulip_tpu_torch.train import step as TS

FLAGSHIP = dict(img_size=(32, 2048), target_img_size=(128, 2048),
                patch_size=(1, 4), window_size=(2, 8), pixel_shuffle=True,
                circular_padding=True, log_transform=True,
                patch_unmerging=True)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def exchanges(spec, rank, world):
    """Each op on this rank's W shard of seeded float64 tensors, under a
    ring of ``world``, against the op on the joined tensor: outputs and
    the gradients of a seeded cotangent.  Returns the checks that
    failed (an empty list) and the exchange count."""
    mesh = Mesh(1, world, rank)
    g = torch.Generator().manual_seed(0)
    w = 8
    X = torch.randn(2, 3, w * world, 5, generator=g, dtype=torch.float64)
    cols = slice(rank * w, (rank + 1) * w)
    cases = [(f"roll_w {s}", lambda t, s=s: halo.roll_w(t, s), 0)
             for s in (-4, -3, -2, -1, 1, 2, 3, 4)]
    cases += [(f"roll_hw (1, {s})", lambda t, s=s: halo.roll_hw(t, 1, s), 0)
              for s in (-4, 4)]
    cases += [("circular_pad_w (2, 2)",
               lambda t: halo.circular_pad_w(t, 2, 2), 4),
              ("circular_pad_w (2, 3)",
               lambda t: halo.circular_pad_w(t, 2, 3), 5)]
    bad = []
    for name, op, grow in cases:
        xl = X[:, :, cols].clone().requires_grad_(True)
        xr = X.clone().requires_grad_(True)
        with halo.sequence_axis(mesh.ring()):
            y = op(xl)
        ref = op(xr)
        out_cols = slice(rank * w, rank * w + w + grow)
        G = torch.randn(ref.shape, generator=g, dtype=torch.float64)
        if grow:   # a pad's columns: shard r holds joined columns r*w...
            shards = torch.cat([ref[:, :, r * w:r * w + w + grow]
                                for r in range(world)], dim=2)
            Gs = torch.randn(shards.shape, generator=g, dtype=torch.float64)
            (gr,) = torch.autograd.grad(shards, xr, Gs)
            Gl = Gs[:, :, rank * (w + grow):(rank + 1) * (w + grow)]
        else:
            (gr,) = torch.autograd.grad(ref, xr, G)
            Gl = G[:, :, out_cols]
        (gl,) = torch.autograd.grad(y, xl, Gl)
        if not torch.equal(y, ref[:, :, out_cols]):
            bad.append(f"{name} forward")
        if not torch.equal(gl, gr[:, :, cols]):
            bad.append(f"{name} gradient")
    return bad, halo.exchanges()


def sp_train_steps(spec, rank=0, world=1):
    """test_torch_dp.train_steps under W-axis sequence parallel: ``world``
    ranks as world // sp data indices of ``spec["sp"]`` seq ranks; this
    rank takes its data index's rows of each joined batch and its W shard
    of them, and the sharded step (``make_sp_train_step``).  Returns what
    train_steps returns."""
    sp = spec["sp"]
    mesh = make_mesh(sp)
    assert (mesh.dp, mesh.sp) == (world // sp, sp)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    cfg = model_config("tulip_base", drop_path_rate=spec["rate"], **KW)
    model = TT.TULIP(cfg)
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    model = model.to(dtype)
    if rank > 0:
        with torch.no_grad():   # replicate() must overwrite these
            for p in model.parameters():
                p.add_(1.0)
    replicate(model)
    opt = TS.make_optimizer(model, 0.01)
    grads, dropped = [], [0]
    opt_step, drop_path = opt.step, L.drop_path

    def recording_step(*a, **k):
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        return opt_step(*a, **k)

    def counting_drop_path(x, rate, generator, active):
        y = drop_path(x, rate, generator, active)
        if y is not x:
            dropped[0] += int((y.reshape(y.shape[0], -1) == 0).all(1).sum())
        return y

    if spec.get("no_backward_exchange"):
        halo._Halo.backward = staticmethod(
            lambda ctx, a, b: (None, None, None))
    opt.step = recording_step
    L.drop_path = counting_drop_path
    step = SP.make_sp_train_step(model, opt, mesh,
                                 accum_iter=spec["accum_iter"],
                                 compute_dtype=dtype)
    with np.load(spec["batches"]) as f:
        batches = {k: f[k] for k in ("low", "high")}
    generator = torch.Generator().manual_seed(spec["seed"])
    draws = L.RankDraws(generator, mesh.data_index, mesh.dp)
    out = []
    try:
        for i in range(spec["steps"]):
            low, high = (batches[k][i % len(batches["low"])]
                         for k in ("low", "high"))
            b = low.shape[0] // mesh.dp
            rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
            low, high = slice_w(({"sample": low[rows]},
                                 {"sample": high[rows]}), mesh.seq_index, sp)
            total, pixel = step(torch.from_numpy(low["sample"]).to(dtype),
                                torch.from_numpy(high["sample"]).to(dtype),
                                spec.get("lr", LR), draws)
            out.append(dict(loss=(total.item(), pixel.item()),
                            weights={n: p.detach().clone()
                                     for n, p in model.named_parameters()}))
    finally:
        L.drop_path = drop_path
    return out, grads, dropped[0], halo.exchanges()


def sp_forward(spec, rank, world):
    """The fp32 eval forward of this rank's W shard of spec["x"], gathered:
    (the joined pred, the exchange count)."""
    mesh = make_mesh(world)
    cfg = model_config("tulip_base", **KW)
    model = TT.TULIP(cfg)
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    fwd = SP.make_sp_eval_forward(model, mesh, mode="eval",
                                  compute_dtype=torch.float32)
    x = torch.from_numpy(np.load(spec["x"]))
    return fwd(x), halo.exchanges()


def sp_mcdrop(spec, rank, world):
    """eval/engine.py:MCdrop (10 iterations, the rate-0 shortcut) on two
    CARLA samples of test_torch_eval.py, its forward this ring's
    make_sp_eval_forward(mode "mc") or, in a world of 1, the model's own:
    (the results, the preds the forward gave, the exchange count)."""
    from test_torch_eval import _Args, _Loader
    from tulip_tpu_torch.eval import engine as TE
    from tulip_tpu_torch.utils.writer import TBWriter
    model = TT.TULIP(model_config("tulip_base", **KW))
    model.load_state_dict(torch.load(spec["params"], weights_only=True))
    out_dir = spec["out_dir"] % rank
    preds, sp_forward = [], None
    if world > 1:
        fwd = SP.make_sp_eval_forward(model, make_mesh(world), mode="mc",
                                      compute_dtype=torch.float32)

        def sp_forward(low):
            preds.append(fwd(low))
            return preds[-1]
    else:
        orig = TT.apply_model

        def recording(*a, **k):
            preds.append(orig(*a, **k))
            return preds[-1]

        TE.apply_model = recording
    try:
        res = TE.MCdrop(_Loader((16, 256), (64, 256)), model,
                        TBWriter(out_dir + "/tb"),
                        args=_Args("carla", (16, 256), (64, 256), out_dir),
                        device=torch.device("cpu"), sp_forward=sp_forward)
    finally:
        if world == 1:
            TE.apply_model = orig
    return res, preds, halo.exchanges()


_RANK = """
import json, sys
import torch
import torch.distributed as td
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[3])
import test_torch_sp as T
rank, spec = int(sys.argv[1]), json.load(open(sys.argv[2]))
world = spec["world"]
td.init_process_group("gloo", store=td.FileStore(spec["store"], world),
                      rank=rank, world_size=world)
torch.save(getattr(T, spec["fn"])(spec, rank, world), spec["out"] % rank)
td.destroy_process_group()
"""


def ranks(tmp_path, spec):
    spec = dict(spec, store=str(tmp_path / "store"),
                out=str(tmp_path / "rank%d.pt"))
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    run_ranks([[sys.executable, "-c", _RANK, str(r), str(path), TESTS]
               for r in range(spec["world"])], tmp_path)
    return [torch.load(spec["out"] % r, weights_only=True)
            for r in range(spec["world"])]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Weights of the small config (the port's init), two joined batches
    of 2 and one of 4, in files the ranks read."""
    root = tmp_path_factory.mktemp("sp")
    cfg = model_config("tulip_base", **KW)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    torch.save(params, root / "params.pt")
    rng = np.random.default_rng(0)
    np.savez(root / "batches.npz",
             low=rng.uniform(0, 1, (2, 2, 1, 16, 256)).astype(np.float32),
             high=rng.uniform(0, 1, (2, 2, 1, 64, 256)).astype(np.float32))
    np.savez(root / "batches4.npz",
             low=rng.uniform(0, 1, (1, 4, 1, 16, 256)).astype(np.float32),
             high=rng.uniform(0, 1, (1, 4, 1, 64, 256)).astype(np.float32))
    np.save(root / "x.npy",
            rng.uniform(0, 1, (2, 1, 16, 256)).astype(np.float32))
    return dict(params=str(root / "params.pt"),
                batches=str(root / "batches.npz"),
                batches4=str(root / "batches4.npz"), x=str(root / "x.npy"))


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_exchanges_equal_the_single_device_ops(tmp_path, world):
    out = ranks(tmp_path, dict(fn="exchanges", world=world))
    for bad, n in out:
        assert bad == []
        # 10 rolls and 2 pads, each forward and backward
        assert n == 24


def test_outside_a_ring_the_ops_are_todays():
    x = torch.randn(2, 4, 16, 3, generator=torch.Generator().manual_seed(1))
    assert halo.current_sequence_axis() is None and not halo.sharded()
    assert torch.equal(halo.roll_hw(x, 1, -4),
                       torch.roll(x, shifts=(1, -4), dims=(1, 2)))
    assert torch.equal(halo.roll_w(x, 3), torch.roll(x, 3, dims=2))
    assert halo.roll_hw(x, 0, 0) is x and halo.roll_w(x, 0) is x
    assert torch.equal(halo.circular_pad_w(x, 2, 2),
                       torch.cat([x[:, :, 14:], x, x[:, :, :2]], dim=2))
    # a ring of one rank is the single device
    with halo.sequence_axis(Mesh(1, 1, 0).ring()):
        assert not halo.sharded()
        assert torch.equal(halo.roll_hw(x, 1, -4),
                           torch.roll(x, shifts=(1, -4), dims=(1, 2)))
    assert halo.current_sequence_axis() is None


def test_a_roll_as_wide_as_the_shard_raises():
    with halo.sequence_axis(Mesh(1, 2, 0).ring()):
        with pytest.raises(ValueError, match="W shard 4 wide"):
            halo.roll_w(torch.zeros(1, 1, 4, 1), -4)


# ---------------------------------------------------------------------------
# the layout and the statics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (1, 4), (2, 4), (4, 1)])
def test_ranks_are_seq_fastest_and_rings_close(dp, sp):
    """rank = d·sp + s as JAX's make_mesh((dp, sp)) orders the devices;
    each ring's neighbours stay within its data index and close the
    cycle."""
    for rank in range(dp * sp):
        m = Mesh(dp, sp, rank)
        assert m.data_index * sp + m.seq_index == rank
        ring = m.ring()
        assert (ring.size, ring.index) == (sp, m.seq_index)
        assert {ring.left // sp, ring.right // sp} == {m.data_index}
        assert Mesh(dp, sp, ring.right).ring().left == rank
        assert Mesh(dp, sp, ring.left).ring().right == rank


def test_a_degree_that_does_not_divide_the_world_raises():
    assert make_mesh(1) == Mesh(1, 1, 0)
    for sp in (2, 3, 0):
        with pytest.raises(ValueError, match="does not divide the world"):
            make_mesh(sp)


def _jax_model(**kw):
    from tulip_tpu.config import model_config as jax_model_config
    from tulip_tpu.models import tulip as JT
    return JT.build_model(jax_model_config("tulip_base", **kw))


@pytest.mark.parametrize("n_seq", [2, 4])
def test_masks_equal_jax_build_sp_statics(n_seq):
    from tulip_tpu.parallel.sp import build_sp_statics
    ref = build_sp_statics(_jax_model(**FLAGSHIP), n_seq)
    got = SP.build_sp_statics(TT.TULIP(model_config("tulip_base",
                                                    **FLAGSHIP),
                                       device="meta"), n_seq)
    shifted = 0
    for stages, jstages in ((got.enc, ref.enc), (got.dec, ref.dec)):
        assert len(stages) == len(jstages)
        for blocks, jblocks in zip(stages, jstages):
            for b, jb in zip(blocks, jblocks):
                assert b.st.grid == jb.st.grid and b.st.shift == jb.st.shift
                if jb.mask_body is None:
                    assert b.mask_body is None and b.st.mask is None
                    continue
                shifted += 1
                np.testing.assert_array_equal(b.st.mask, jb.st.mask)
                np.testing.assert_array_equal(b.mask_body, jb.mask_body)
                # the last variant differs from the body in the last
                # window column only
                (H, W), (wh, ww) = b.st.grid, b.st.window
                last, body = (m.reshape(H // wh, W // ww, -1)
                              for m in (b.st.mask, b.mask_body))
                np.testing.assert_array_equal(last[:, :-1], body[:, :-1])
                assert not np.array_equal(last[:, -1], body[:, -1])
    assert shifted == 7


def test_max_sp_degree_equals_jax_where_jax_is_right():
    from tulip_tpu.parallel.sp import max_sp_degree
    for kw, want in ((FLAGSHIP, 4), (KW, 2)):
        model = TT.TULIP(model_config("tulip_base", **kw), device="meta")
        assert SP.max_sp_degree(model) == max_sp_degree(_jax_model(**kw)) \
            == want
        SP.build_sp_statics(model, want)
    # four stages at 16 x 256: the third stage (4 x 16 tokens, window 2 x
    # 8) cannot give 2 shards two window columns each; JAX's loop lets the
    # next stage's cap replace the cap of 1 (ROADMAP, JAX findings)
    cli = dict(KW, depths=None, num_heads=None)
    model = TT.TULIP(model_config("tulip_base", **cli), device="meta")
    assert SP.max_sp_degree(model) == 1
    assert max_sp_degree(_jax_model(**cli)) == 2
    with pytest.raises(ValueError, match="too narrow"):
        SP.build_sp_statics(model, 2)


def test_slice_w_cuts_the_samples_only():
    low = np.arange(2 * 1 * 2 * 8, dtype=np.float32).reshape(2, 1, 2, 8)
    batch = ({"sample": low, "name": ["a", "b"]},
             {"sample": low * 10, "name": ["a", "b"]})
    parts = [slice_w(batch, s, 4) for s in range(4)]
    for k in range(2):
        joined = np.concatenate([p[k]["sample"] for p in parts], axis=-1)
        np.testing.assert_array_equal(joined, batch[k]["sample"])
        assert all(p[k]["name"] == ["a", "b"] for p in parts)
    assert parts[1][0]["sample"].flags["C_CONTIGUOUS"]


def test_seq_ranks_of_a_data_index_keep_the_same_rows():
    """Under dp x sp each rank draws with RankDraws(generator, data index,
    dp): the sp ranks of a data index drop the same samples, and the rows
    are those of one process's draw on the joined batch."""
    dp, sp, b, rate = 2, 2, 3, 0.5
    x = torch.randn(dp * b, 2, 3, 4, generator=torch.Generator()
                    .manual_seed(1)) + 3.0
    want = L.drop_path(x, rate, torch.Generator().manual_seed(5), True)
    for rank in range(dp * sp):
        m = Mesh(dp, sp, rank)
        rows = slice(m.data_index * b, (m.data_index + 1) * b)
        got = L.drop_path(x[rows], rate, L.RankDraws(
            torch.Generator().manual_seed(5), m.data_index, m.dp), True)
        assert torch.equal(got, want[rows])
    kept = (want.reshape(dp * b, -1) != 0).all(1)
    assert 0 < int(kept.sum()) < dp * b


# ---------------------------------------------------------------------------
# the forward and the step
# ---------------------------------------------------------------------------

def test_forward_of_two_seq_ranks_equals_one_process_and_jax(data, tmp_path):
    import jax.numpy as jnp
    from tulip_tpu.models import tulip as JT
    from tulip_tpu_torch.utils.checkpoint import jax_params_from_state_dict
    out = ranks(tmp_path, dict(data, fn="sp_forward", world=2))
    x = np.load(data["x"])
    model = TT.TULIP(model_config("tulip_base", **KW))
    model.load_state_dict(torch.load(data["params"], weights_only=True))
    ref = TT.apply_model(model, torch.from_numpy(x), mode="eval",
                         mc_drop=True)
    params = {k: jnp.asarray(v) for k, v in jax_params_from_state_dict(
        model.state_dict()).items()}
    jpred = np.asarray(JT.apply_model(
        params, _jax_model(**KW), jnp.asarray(x), None, mode="eval",
        mc_drop=True, compute_dtype=jnp.float32))
    for pred, n in out:
        assert pred.shape == ref.shape == (2, 1, 64, 256)
        # 3 shifted blocks x 2 rolls + the pad
        assert n == 7
        assert float((pred - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
        assert np.abs(pred.numpy() - jpred).max() <= 1e-4 * np.abs(
            jpred).max()
    assert torch.equal(out[0][0], out[1][0])


def test_mcdrop_of_two_seq_ranks_equals_one_process(data, tmp_path):
    """MCdrop through make_sp_eval_forward on two seq ranks against one
    process on the same weights, with the limits of the forward test above
    (preds 1e-5 of max|ref|) and of test_torch_sp_cli.py's --eval under
    two ranks (results 1e-5 relative)."""
    spec = dict(data, out_dir=str(tmp_path / "mc%d"))
    out = ranks(tmp_path, dict(spec, fn="sp_mcdrop", world=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref, ref_preds, _ = sp_mcdrop(
            dict(spec, out_dir=str(tmp_path / "one%d")), 0, 1)
    finally:
        torch.set_num_threads(threads)
    assert len(ref_preds) == 2     # one forward a sample at rate 0
    for res, preds, n in out:
        assert n == 7 * len(preds) and len(preds) == 2
        for p, r in zip(preds, ref_preds):
            assert p.shape == r.shape == (1, 1, 64, 256)
            assert float((p - r).abs().max()) <= 1e-5 * float(r.abs().max())
        assert set(res) == set(ref) == {"mae", "chamfer_dist", "iou",
                                        "precision", "recall", "f1"}
        for k, v in ref.items():
            assert len(res[k]) == len(v) == 2
            np.testing.assert_allclose(res[k], v, rtol=1e-5, err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    # rank 0 alone writes the results file
    assert (tmp_path / "mc0" / "results_mcdrop.txt").exists()
    assert not (tmp_path / "mc1" / "results_mcdrop.txt").exists()


def _check_step(got, ref, spec, n_steps):
    """test_torch_dp.py's limits, and the ranks' weights bit-equal."""
    (got0, grads0, _, _), others = got[0], got[1:]
    want, ref_grads, ref_dropped = ref
    if spec["rate"]:
        # the seq-0 rank of each data index counts its rows' drops
        assert ref_dropped > 0
        assert sum(r[2] for r in got[::spec["sp"]]) == ref_dropped
    assert len(grads0) == len(ref_grads) == n_steps
    for i, w in enumerate(want):
        for o in others:
            assert o[0][i]["loss"] == got0[i]["loss"]
            for k, v in got0[i]["weights"].items():
                assert torch.equal(v, o[0][i]["weights"][k]), (i, k)
        np.testing.assert_allclose(got0[i]["loss"], w["loss"], rtol=1e-5)
        _within(got0[i]["weights"], w["weights"], 1e-5, per_tensor=False)
    for j, (g, w) in enumerate(zip(grads0, ref_grads)):
        _within(g, w, 1e-5, per_tensor=j == 0)


def test_step_of_two_seq_ranks_equals_one_process(data, tmp_path):
    spec = dict(data, rate=0.1, seed=2, accum_iter=1, steps=2, sp=2)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=2))
    _check_step(got, _one_process(spec), spec, 2)
    # per step: 7 exchanges forward (3 shifted blocks x 2 rolls + the
    # pad), 6 backward (the pad's input, the image, takes no gradient)
    assert got[0][3] == got[1][3] == 2 * 13
    params = torch.load(data["params"], weights_only=True)
    assert max(float((got[0][0][-1]["weights"][k] - params[k]).abs().max())
               for k in params) >= 0.5 * LR


def test_in_float64_seq_ranks_stay_on_one_process_for_16_steps(data,
                                                               tmp_path):
    """Over many fp32 AdamW steps any two runs that sum in other orders
    drift apart (a gradient entry's rounding noise becomes a move of up
    to lr), with W shards or without; in float64 the noise is 1e-16, and
    two seq ranks keep one process's weights over 16 steps at lr 5e-4 and
    drop-path 0.1 to 1e-10 of the model's max.  (The loss itself is
    computed in fp32, so the losses agree to its rounding.)"""
    spec = dict(data, rate=0.1, seed=4, accum_iter=1, steps=16, sp=2,
                dtype="float64", lr=5e-4)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:    # one process: a ring of one shard is the unsharded model
        ref = sp_train_steps(dict(spec, sp=1))
    finally:
        torch.set_num_threads(threads)
    assert ref[2] > 0 and got[0][2] == ref[2]
    for g, w in zip(got[0][0], ref[0]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
    _within(got[0][0][-1]["weights"], ref[0][-1]["weights"], 1e-10,
            per_tensor=False)
    params = torch.load(data["params"], weights_only=True)
    assert max(float((ref[0][-1]["weights"][k] - params[k]).abs().max())
               for k in params) >= 10 * 5e-4


def test_dp2_sp2_on_four_ranks_equals_one_process(data, tmp_path):
    """Two data indices of two seq ranks, batch 2 each, against one
    process on the joined batch of 4; drop-path 0.1 and accum_iter 2 (the
    checkpoint's accumulation buffer is the world mean too)."""
    spec = dict(data, batches=data["batches4"], rate=0.1, seed=3,
                accum_iter=2, steps=2, sp=2)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=4))
    _check_step(got, _one_process(spec), spec, 1)


def test_ranks_without_the_backward_exchange_miss_the_gradient(data,
                                                               tmp_path):
    """The mutant the step test must catch: the halo's backward returns
    nothing, so a column's cotangent never reaches its owner.  Its first
    gradient misses one process's by far more than the 1e-5 limit."""
    spec = dict(data, rate=0.0, seed=2, accum_iter=1, steps=1, sp=2)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=2,
                               no_backward_exchange=True))
    ref, ref_grads, _ = _one_process(spec)
    with pytest.raises(AssertionError):
        _within(got[0][1][0], ref_grads[0], 1e-5)
    errs = [float((got[0][1][0][k] - v).abs().max() / v.abs().max())
            for k, v in ref_grads[0].items() if v.abs().max() > 0]
    assert max(errs) > 1e-2
    # the forward was untouched: the loss is one process's
    np.testing.assert_allclose(got[0][0][0]["loss"], ref[0]["loss"],
                               rtol=1e-5)


def test_two_seq_ranks_match_the_jax_step(tmp_path):
    import jax
    import jax.numpy as jnp
    from tulip_tpu.config import model_config as jax_model_config
    from tulip_tpu.models import tulip as JT
    from tulip_tpu.train import step as JS
    from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                  state_dict_from_jax)
    from test_torch_train import _check_moves

    cfg = jax_model_config("tulip_base", drop_path_rate=0.0, **KW)
    params = {k: np.asarray(v) for k, v in
              JT.init_params(jax.random.PRNGKey(0), cfg).items()}
    torch.save(state_dict_from_jax(params), tmp_path / "params.pt")
    rng = np.random.default_rng(1)
    low = rng.uniform(0, 1, (2, 2, 1, 16, 256)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 2, 1, 64, 256)).astype(np.float32)
    np.savez(tmp_path / "batches.npz", low=low, high=high)
    spec = dict(params=str(tmp_path / "params.pt"),
                batches=str(tmp_path / "batches.npz"), rate=0.0, seed=0,
                accum_iter=1, steps=2, sp=2)
    got = ranks(tmp_path, dict(spec, fn="sp_train_steps", world=2))

    jmodel = JT.build_model(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def loss_fn(p):
        return JT.apply_model(p, jmodel, jnp.asarray(low[0]),
                              jnp.asarray(high[0]), mode="train",
                              rng=jax.random.PRNGKey(1),
                              compute_dtype=jnp.float32)[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    tx = JS.make_optimizer(0.01, 1)
    jstep = JS.make_train_step(jmodel, tx, compute_dtype=jnp.float32,
                               donate=False)
    state = JS.init_train_state(jparams, tx)
    for i in range(2):
        state, _ = jstep(state, jnp.asarray(low[i]), jnp.asarray(high[i]),
                         np.float32(LR), jax.random.PRNGKey(i))
        _check_moves(jax_params_from_state_dict(got[0][0][i]["weights"]),
                     {k: np.asarray(v) for k, v in state.params.items()},
                     i + 1)
    assert abs(got[0][0][0]["loss"][0] - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    grads = jax_params_from_state_dict(got[0][1][0])
    assert set(grads) == set(jgrads)
    errs = {k: float(np.abs(grads[k] - np.asarray(jgrads[k])).max()
                     / np.abs(np.asarray(jgrads[k])).max()) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
