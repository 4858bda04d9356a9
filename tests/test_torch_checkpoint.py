"""Checkpoints of the port (tulip_tpu_torch.utils.checkpoint) against the
JAX package's, both ways, on the two-stage TULIP-base of test_torch_train
(16x256 -> 64x256, fp32).

- JAX native file -> port: the weights load strictly and give JAX's forward
  (1e-5 of max|ref|); AdamW's step count and moments arrive exactly (the
  same numbers in torch layouts), optax.MultiSteps' buffer too.
- port .pth -> JAX (the torch branch of its load_checkpoint): the params
  are the originals exactly.
- the optimizer carried across: two JAX AdamW steps, JAX save_model, port
  load_model, a third step on both sides.  The gradient the port hands
  AdamW is JAX's within 1e-4 of each tensor's max (test_torch_train's
  limit), and JAX's AdamW on the carried state, handed the port's
  gradient, moves every element as the port did: within 1e-2 lr, the mean
  difference below 1e-3 lr (without the restored moments the first port
  step would move every element by about lr * sign(g)).  The weights are
  not held to JAX's own step: AdamW divides each element by its own
  gradient's size, so an element whose gradient is near zero moves by a
  share of lr that the rounding of the two packages' gradients decides
  (one host measured 0.047 lr, another passed 1e-2 lr).
"""

import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu.train import step as JS
from tulip_tpu.utils import checkpoint as JC
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.train import step as TS
from tulip_tpu_torch.utils import checkpoint as TC

KW = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True, depths=(2, 2),
          num_heads=(3, 6))
LR, WD = 1e-4, 0.01


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test processes share the machine's cores; full-width torch
    thread pools in each of them mostly wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = model_config("tulip_base", drop_path_rate=0.0, **KW)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(0, 1, (2, 1, 16, 256)).astype(np.float32),
                rng.uniform(0, 1, (2, 1, 64, 256)).astype(np.float32))
               for _ in range(4)]
    return cfg, params, batches


def _ns(tmp_path, **kw):
    a = dict(output_dir=str(tmp_path), resume="", eval=False, start_epoch=0,
             lr=LR, mesh_shape=None)
    a.update(kw)
    return types.SimpleNamespace(**a)


def test_jax_checkpoint_loads_into_the_port(setup, tmp_path):
    cfg, params, batches = setup
    path = str(tmp_path / "checkpoint-3.pth")
    JC.save_checkpoint(path, params, None, 3, {"lr": LR})
    ckpt = TC.load_checkpoint(path)
    assert ckpt["format"] == "tulip_tpu" and ckpt["epoch"] == 3
    assert ckpt["optimizer"] is None and ckpt["args"] == {"lr": LR}
    model = TT.TULIP(cfg)
    model.load_state_dict(ckpt["model"], strict=True)
    x = batches[0][0]
    ref = np.asarray(JT.apply_model(params, JT.build_model(cfg),
                                    jnp.asarray(x), mode="mc", mc_drop=True,
                                    compute_dtype=jnp.float32))
    pred = TT.apply_model(model, torch.from_numpy(x), mode="mc", mc_drop=True)
    assert np.abs(pred.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # a native file without an optimizer still moves start_epoch on resume
    args = _ns(tmp_path, resume=path)
    assert TC.load_model(args, TT.TULIP(cfg), None) == 4


def test_port_checkpoint_loads_into_jax(setup, tmp_path):
    cfg, params, _ = setup
    model = TT.TULIP(cfg)
    TC.load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    opt = TS.make_optimizer(model, WD)
    args = _ns(tmp_path, note=object())      # non-plain values are left out
    TC.save_model(args, 7, model, opt)
    path = tmp_path / "checkpoint-7.pth"
    assert path.exists() and not (tmp_path / "checkpoint-7.pth.tmp").exists()
    raw = torch.load(str(path), weights_only=True)
    assert set(raw) == {"model", "optimizer", "epoch", "scaler", "args"}
    assert raw["scaler"] == {} and raw["epoch"] == 7
    assert "note" not in raw["args"] and raw["args"]["lr"] == LR
    assert set(raw["model"]) == set(model.state_dict())
    back = JC.load_checkpoint(str(path))
    assert back["format"] == "torch" and back["epoch"] == 7
    assert set(back["model"]) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back["model"][k], np.asarray(v))


def test_legacy_keys_are_remapped_and_buffers_dropped(setup, tmp_path):
    cfg, params, _ = setup
    model = TT.TULIP(cfg)
    TC.load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    sd = dict(model.state_dict())
    old = {"decoder_pred.weight": "head.weight",
           "ps_head.conv_expand.0.weight":
               "pixel_shuffle_layer.conv_expand.0.weight",
           "ps_head.conv_expand.0.bias":
               "pixel_shuffle_layer.conv_expand.0.bias"}
    legacy = {old.get(k, k): v for k, v in sd.items()}
    legacy["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    legacy["layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    legacy["layers.0.blocks.0.attn.relative_coords_table"] = torch.zeros(3)
    path = str(tmp_path / "released.pth")
    # a bare state dict, and one wrapped with an argparse.Namespace inside
    torch.save(legacy, path)
    ckpt = TC.load_checkpoint(path)
    assert set(ckpt["model"]) == set(sd) and ckpt["epoch"] is None
    import argparse
    torch.save({"model": legacy, "epoch": 599,
                "args": argparse.Namespace(lr=1.0)}, path)
    ckpt = TC.load_checkpoint(path)
    assert set(ckpt["model"]) == set(sd) and ckpt["epoch"] == 599
    fresh = TT.TULIP(cfg)
    fresh.load_state_dict(ckpt["model"], strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k])
    jax_side = JC.load_checkpoint(path)["model"]
    assert set(jax_side) == set(params)


def _jax_grads(cfg, params, low, high, rng):
    """The gradient of JAX's fp32 training loss (the one its train step
    takes) at params."""
    model = JT.build_model(cfg)

    def loss_fn(p):
        return JT.apply_model(p, model, jnp.asarray(low), jnp.asarray(high),
                              mode="train", rng=rng,
                              compute_dtype=jnp.float32)[1]

    g = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in params.items()})
    return {k: np.asarray(v) for k, v in g.items()}


def _jax_steps(cfg, params, batches, n, accum_iter):
    tx = JS.make_optimizer(WD, accum_iter)
    step = JS.make_train_step(JT.build_model(cfg), tx, accum_iter=accum_iter,
                              compute_dtype=jnp.float32, donate=False)
    state = JS.init_train_state(params, tx)
    for i in range(n):
        low, high = batches[i]
        state, _ = step(state, jnp.asarray(low), jnp.asarray(high),
                        np.float32(LR), jax.random.PRNGKey(i))
    return step, state


@pytest.mark.parametrize("accum_iter,n_before", [(1, 2), (2, 3)])
def test_optimizer_is_carried_from_jax_to_the_port(setup, tmp_path,
                                                   accum_iter, n_before):
    """n_before JAX micro-steps, JAX save_model, port load_model, one more
    micro-step on both sides (with accum_iter 2 the save falls in the middle
    of an accumulation and the next micro-step is the one that updates)."""
    cfg, params, batches = setup
    jstep, state = _jax_steps(cfg, params, batches, n_before, accum_iter)
    args = _ns(tmp_path)
    JC.save_model(args, 4, state.params, state.opt_state)
    low, high = batches[n_before]
    state2, _ = jstep(state, jnp.asarray(low), jnp.asarray(high),
                      np.float32(LR), jax.random.PRNGKey(9))
    ref = {k: np.asarray(v) for k, v in state2.params.items()}
    before = {k: np.asarray(v) for k, v in state.params.items()}

    model = TT.TULIP(cfg)
    model.load_state_dict(TT.init_params(cfg, torch.Generator().manual_seed(5)))
    opt = TS.make_optimizer(model, WD)
    step = TS.make_train_step(model, opt, accum_iter=accum_iter,
                              compute_dtype=torch.float32)
    args.resume = str(tmp_path / "checkpoint-4.pth")
    assert TC.load_model(args, model, opt, step) == 5
    # the weights and the moments are JAX's, exactly
    got = TC.jax_params_from_state_dict(model.state_dict())
    for k in before:
        np.testing.assert_array_equal(got[k], before[k])
    adam = state.opt_state.inner_opt_state if accum_iter > 1 else state.opt_state
    adam = adam.inner_state[0]
    names = {id(p): n for n, p in model.named_parameters()}
    mu = TC.jax_params_from_state_dict(
        {names[id(p)]: s["exp_avg"] for p, s in opt.state.items()})
    nu = TC.jax_params_from_state_dict(
        {names[id(p)]: s["exp_avg_sq"] for p, s in opt.state.items()})
    assert set(mu) == set(before)
    for k in before:
        np.testing.assert_array_equal(mu[k], np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(nu[k], np.asarray(adam.nu[k]))
    n_updates = n_before // accum_iter
    assert all(float(s["step"]) == n_updates == int(adam.count)
               for s in opt.state.values())
    if accum_iter > 1:
        sd = step.state_dict()
        assert sd["micro"] == 1
        acc = TC.jax_params_from_state_dict(sd["grads"])
        for k in before:     # the mean of 1 micro-step, over accum_iter
            np.testing.assert_allclose(
                acc[k], np.asarray(state.opt_state.acc_grads[k]) / accum_iter,
                rtol=1e-6, atol=0)

    handed = []
    opt_step = opt.step

    def recording_step(*a, **k):
        handed.append({names[id(p)]: p.grad.clone()
                       for p in model.parameters()})
        return opt_step(*a, **k)

    opt.step = recording_step
    step(torch.from_numpy(low), torch.from_numpy(high), LR)
    ours = TC.jax_params_from_state_dict(model.state_dict())
    moved = max(float(np.abs(ref[k] - before[k]).max()) for k in ref)
    assert moved >= 0.5 * LR                 # the step did move the weights
    # the gradient AdamW was handed: the port's last micro-step against
    # JAX's (with accum_iter 2 averaged with the carried buffer)
    assert len(handed) == 1
    grads = TC.jax_params_from_state_dict(handed[0])
    g_last = _jax_grads(cfg, before, low, high, jax.random.PRNGKey(9))
    for k in before:
        want = g_last[k]
        if accum_iter > 1:
            want = (np.asarray(state.opt_state.acc_grads[k]) + want) / 2
        err = np.abs(grads[k] - want).max() / np.abs(want).max()
        assert err <= 1e-4, (k, err)
    # the update: JAX's AdamW on the carried state, handed the same
    # gradient, moves every element as the port did
    inner = JS.make_optimizer(WD, 1)
    inner_state = (state.opt_state.inner_opt_state if accum_iter > 1
                   else state.opt_state)
    inner_state.hyperparams["learning_rate"] = jnp.float32(LR)
    upd, _ = inner.update({k: jnp.asarray(v) for k, v in grads.items()},
                          inner_state, state.params)
    want = {k: np.asarray(v) for k, v in
            optax.apply_updates(state.params, upd).items()}
    d = np.concatenate([np.abs(ours[k] - want[k]).ravel() for k in want])
    assert d.max() <= 1e-2 * LR, d.max() / LR
    assert d.mean() <= 1e-3 * LR


def test_port_resume_mid_accumulation_is_exact(setup, tmp_path):
    """Port -> port with accum_iter 2: save after the third micro-step,
    resume in a fresh process state, and the fourth gives the bits of the
    uninterrupted run."""
    cfg, params, batches = setup
    p = {k: np.asarray(v) for k, v in params.items()}

    def fresh():
        model = TT.TULIP(cfg)
        TC.load_jax_params(model, p)
        opt = TS.make_optimizer(model, WD)
        return model, opt, TS.make_train_step(model, opt, accum_iter=2,
                                              compute_dtype=torch.float32)

    t = lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1]))
    model, opt, step = fresh()
    for i in range(3):
        step(*t(batches[i]), LR)
    args = _ns(tmp_path)
    TC.save_model(args, 0, model, opt, step)
    raw = torch.load(str(tmp_path / "checkpoint-0.pth"), weights_only=True)
    assert raw["accum"]["micro"] == 1 and set(raw["accum"]["grads"]) == set(p)
    step(*t(batches[3]), LR)
    model2, opt2, step2 = fresh()
    args.resume = str(tmp_path / "checkpoint-0.pth")
    assert TC.load_model(args, model2, opt2, step2) == 1
    step2(*t(batches[3]), LR)
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k
    # accum_iter 1 carries nothing
    m1 = TT.TULIP(cfg)
    assert TS.make_train_step(m1, TS.make_optimizer(m1, WD)).state_dict() is None


def test_an_unknown_optimizer_tree_raises_with_the_path(setup, tmp_path):
    cfg, params, _ = setup
    path = str(tmp_path / "checkpoint-0.pth")
    JC.save_checkpoint(path, params, {"momentum": np.zeros(3)}, 0, {})
    with pytest.raises(ValueError, match="checkpoint-0.pth.*ScaleByAdamState"):
        TC.load_checkpoint(path)


def test_get_latest_checkpoint(tmp_path, capsys):
    for name in ("checkpoint-2.pth", "checkpoint-10.pth", "checkpoint-x.pth",
                 "other.pth"):
        (tmp_path / name).write_bytes(b"")
    args = _ns(tmp_path)
    TC.get_latest_checkpoint(args)
    assert args.resume == os.path.join(str(tmp_path), "checkpoint-10.pth")
    assert "Find checkpoint" in capsys.readouterr().out
    empty = _ns(tmp_path / "none")
    TC.get_latest_checkpoint(empty)
    assert empty.resume == ""


def test_load_model_errors_and_eval(setup, tmp_path, capsys):
    cfg, params, batches = setup
    _, state = _jax_steps(cfg, params, batches, 1, 1)
    args = _ns(tmp_path)
    JC.save_model(args, 2, state.params, state.opt_state)
    args.resume = str(tmp_path / "checkpoint-2.pth")
    # no --resume: nothing happens
    model = TT.TULIP(cfg)
    assert TC.load_model(_ns(tmp_path, start_epoch=3), model, None) == 3
    # key mismatch
    other = TT.TULIP(model_config("tulip_base", **dict(KW, depths=(2, 2, 2),
                                                       num_heads=(3, 6, 12))))
    with pytest.raises(KeyError, match="checkpoint key mismatch"):
        TC.load_model(args, other, None)
    # shape mismatch: the same keys at another window size
    wide = TT.TULIP(model_config("tulip_base", **dict(KW, window_size=(2, 4))))
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_model(args, wide, None)
    # --eval: model only, the optimizer and start_epoch stay
    opt = TS.make_optimizer(model, WD)
    args.eval = True
    assert TC.load_model(args, model, opt) == 0
    assert len(opt.state) == 0
    out = capsys.readouterr().out
    assert "Resume checkpoint" in out and "With optim & sched!" not in out
    args.eval = False
    assert TC.load_model(args, model, opt) == 3
    assert len(opt.state) == len(list(model.parameters()))
    assert "With optim & sched!" in capsys.readouterr().out


def test_initialize_decoder_weights_equals_the_original():
    keys = ["layers.0.blocks.0.mlp.fc1.weight", "layers.0.downsample.norm.bias",
            "layers.1.blocks.1.attn.qkv.weight", "layers.2.blocks.0.norm1.bias",
            "layers_up.2.blocks.0.mlp.fc1.weight",
            "layers_up.2.upsample.norm.bias",
            "layers_up.1.blocks.1.attn.qkv.weight",
            "layers_up.0.blocks.0.norm1.bias", "head.weight",
            "decoder_pred.weight", "skip_connection.weight",
            "first_patch_expanding.expand.weight", "patch_embed.proj.weight",
            "norm_up.weight", "layers.3.blocks.0.norm1.bias"]
    mk = lambda: {k: i for i, k in enumerate(keys)}
    assert TC.initialize_decoder_weights(mk()) == \
        JC.initialize_decoder_weights(mk())
