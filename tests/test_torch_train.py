"""The port's training slice (tulip_tpu_torch.train, apply_model(mode=
"train"), drop-path) against the JAX package on the CPU.

A two-stage TULIP-base (depths (2, 2), heads (3, 6)) at 16x256 -> 64x256,
batch 2, drop_path_rate 0, built in both packages from one JAX
init_params(PRNGKey(0)).  The port's CPU path runs the plain versions and
the written-out backwards of AttnCore, TwoMatmul and LnLinear; JAX runs
jax.grad of its XLA path (attn_impl "grouped"), fp32 throughout.

- loss: 1e-5 relative; each parameter's gradient: 1e-4 of its max|ref|
  (fp32 summation order through ~40 layers of forward and backward);
- weights after 3 AdamW steps at lr 1e-4.  Adam's normalised update moves
  an element by about lr * sign(g) whatever |g|, so an element whose
  gradient sits at the rounding noise (|g| ~ 1e-4 of the tensor's max, the
  gradient limit above) may move by +lr in one package and -lr in the
  other.  Limits: every element within 2 lr per step (Adam's bound); at
  most 0.5 % of the elements beyond 1e-2 lr (measured: 0.05 % after one
  step, 0.13 % after three); the mean difference below 1e-3 lr;
- accum_iter 2 against optax.MultiSteps: the same limits, and no move on
  the first micro-step.
"""

import os
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu.train import step as JS
from tulip_tpu.utils.lr_sched import lr_at_epoch as jax_lr_at_epoch
from tulip_tpu_torch.models import layers as L
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.train import engine as TE
from tulip_tpu_torch.train import step as TS
from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                              load_jax_params)
from tulip_tpu_torch.utils.lr_sched import lr_at_epoch

KW = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True, depths=(2, 2),
          num_heads=(3, 6))
LR, WD, STEPS = 1e-4, 0.01, 3


@pytest.fixture(scope="module")
def setup():
    cfg = model_config("tulip_base", drop_path_rate=0.0, **KW)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    params = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(0, 1, (2, 1, 16, 256)).astype(np.float32),
                rng.uniform(0, 1, (2, 1, 64, 256)).astype(np.float32))
               for _ in range(2)]
    return cfg, params, batches


def _port(cfg, params):
    model = TT.TULIP(cfg)
    load_jax_params(model, params)
    return model


def _jax_train(cfg, params, batches, steps, accum_iter):
    tx = JS.make_optimizer(WD, accum_iter)
    step = JS.make_train_step(JT.build_model(cfg), tx, accum_iter=accum_iter,
                              compute_dtype=jnp.float32, donate=False)
    state = JS.init_train_state({k: jnp.asarray(v) for k, v in params.items()},
                                tx)
    out = []
    for i in range(steps):
        low, high = batches[i % len(batches)]
        state, _ = step(state, jnp.asarray(low), jnp.asarray(high),
                        np.float32(LR), jax.random.PRNGKey(i))
        out.append({k: np.asarray(v) for k, v in state.params.items()})
    return out


def _port_train(cfg, params, batches, steps, accum_iter):
    model = _port(cfg, params)
    step = TS.make_train_step(model, TS.make_optimizer(model, WD),
                              accum_iter=accum_iter,
                              compute_dtype=torch.float32)
    out = []
    for i in range(steps):
        low, high = batches[i % len(batches)]
        step(torch.from_numpy(low), torch.from_numpy(high), LR)
        out.append(jax_params_from_state_dict(model.state_dict()))
    return out


def _max_move_diff(ours, ref):
    return max(float(np.abs(ours[k] - ref[k]).max()) for k in ref)


def _check_moves(ours, ref, steps):
    """The module docstring's AdamW limits after ``steps`` updates."""
    d = np.concatenate([np.abs(ours[k] - ref[k]).ravel() for k in ref])
    assert d.max() <= 2 * LR * steps
    assert (d > 1e-2 * LR).mean() <= 5e-3
    assert d.mean() <= 1e-3 * LR


def test_fp32_loss_and_every_gradient_match_jax(setup):
    cfg, params, batches = setup
    low, high = batches[0]
    jmodel = JT.build_model(cfg)

    def loss_fn(p):
        _, total, _ = JT.apply_model(p, jmodel, jnp.asarray(low),
                                     jnp.asarray(high), mode="train",
                                     rng=jax.random.PRNGKey(1),
                                     compute_dtype=jnp.float32)
        return total

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()})
    model = _port(cfg, params)
    _, total, pixel = TT.apply_model(model, torch.from_numpy(low),
                                     torch.from_numpy(high), mode="train")
    assert total.requires_grad and torch.isfinite(pixel)
    total.backward()
    assert abs(total.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = jax_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    assert set(grads) == set(jgrads)
    errs = {k: float(np.abs(grads[k] - np.asarray(jgrads[k])).max()
                     / np.abs(np.asarray(jgrads[k])).max()) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def test_three_adamw_steps_match_jax(setup):
    cfg, params, batches = setup
    ref = _jax_train(cfg, params, batches, STEPS, 1)
    ours = _port_train(cfg, params, batches, STEPS, 1)
    for i in range(STEPS):
        _check_moves(ours[i], ref[i], i + 1)
    # the weights moved by about lr per step, far beyond the limit
    moved = max(float(np.abs(ref[-1][k] - params[k]).max()) for k in params)
    assert moved >= 0.5 * LR * STEPS


def test_accum_iter_matches_optax_multisteps(setup):
    cfg, params, batches = setup
    ref = _jax_train(cfg, params, batches, 4, 2)
    ours = _port_train(cfg, params, batches, 4, 2)
    # no move on the first micro-step of each pair
    assert _max_move_diff(ours[0], params) == 0.0
    assert _max_move_diff(ref[0], params) == 0.0
    for i in (1, 3):
        _check_moves(ours[i], ref[i], (i + 1) // 2)


def test_train_mode_weight_decay_groups():
    """Decay on the ndim > 1 parameters (linear and conv weights, the bias
    tables), none on biases and LayerNorms, as the JAX mask."""
    model = TT.TULIP(model_config("tulip_base", **KW))
    opt = TS.make_optimizer(model, WD)
    decay, plain = opt.param_groups
    assert decay["weight_decay"] == WD and plain["weight_decay"] == 0.0
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(p.ndim > 1 for p in decay["params"])
    assert all(p.ndim == 1 for p in plain["params"])
    assert any(names[id(p)].endswith("relative_position_bias_table")
               for p in decay["params"])
    assert (len(decay["params"]) + len(plain["params"])
            == len(list(model.parameters())))
    assert opt.defaults["betas"] == (0.9, 0.95) and opt.defaults["eps"] == 1e-8


# ---------------------------------------------------------------------------
# drop-path
# ---------------------------------------------------------------------------

def test_drop_path_is_a_scaled_per_sample_mask():
    x = torch.ones(64, 3, 5, 2)
    y = L.drop_path(x, 0.25, torch.Generator().manual_seed(0), True)
    per_sample = y.reshape(64, -1)
    # each sample is wholly zeroed or wholly scaled by 1 / keep
    assert torch.all((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1))
    kept = int((per_sample[:, 0] != 0).sum())
    assert 0 < kept < 64
    # the same draws from the same seed; the identity when inactive
    again = L.drop_path(x, 0.25, torch.Generator().manual_seed(0), True)
    assert torch.equal(y, again)
    assert L.drop_path(x, 0.25, torch.Generator(), False) is x
    assert L.drop_path(x, 0.0, torch.Generator(), True) is x
    assert L.drop_path(x, 0.25, None, True) is x


def test_block_rates_follow_the_config_schedule():
    cfg = model_config("tulip_base", drop_path_rate=0.1, **KW)
    model = TT.TULIP(cfg)
    for stages, mods in ((cfg.encoder_stages, model.layers),
                         (cfg.decoder_stages, model.layers_up)):
        for st, stage in zip(stages, mods):
            assert tuple(b.st.drop_path for b in stage.blocks) == st.drop_path
    rates = [b.st.drop_path for s in model.layers for b in s.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)


def test_train_mode_draws_from_the_generator(setup):
    """Same generator seed, same loss; another seed, another loss (the
    rates are 0.1 at the deepest block)."""
    cfg, params, batches = setup
    model = TT.TULIP(model_config("tulip_base", drop_path_rate=0.5, **KW))
    load_jax_params(model, params)
    low, high = (torch.from_numpy(a) for a in batches[0])
    loss = lambda seed: TT.apply_model(
        model, low, high, mode="train",
        generator=torch.Generator().manual_seed(seed))[1].item()
    assert loss(3) == loss(3)
    assert len({loss(s) for s in range(4)}) > 1


# ---------------------------------------------------------------------------
# train_one_epoch
# ---------------------------------------------------------------------------

class _Writer:
    logdir = "unused"

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))


def _args(**kw):
    a = dict(accum_iter=1, lr=5e-4, min_lr=0.0, warmup_epochs=2, epochs=4,
             seed=0, log_transform=True)
    a.update(kw)
    return types.SimpleNamespace(**a)


def _durlar_folder(root, n):
    """A synthetic DurLAR train split (range + intensity, 64 x 256)."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "train")
    os.makedirs(d)
    for i in range(n):
        img = np.clip(rng.uniform(5, 100, (64, 1)) + rng.uniform(-2, 2, (64, 256)),
                      0.5, 119.0)
        np.save(os.path.join(d, f"{i:05d}.npy"),
                np.stack([img, rng.uniform(0, 1, (64, 256))], -1)
                .astype(np.float32))


def test_train_one_epoch_on_a_folder(tmp_path, setup):
    from tulip_tpu.data import DataLoader
    from tulip_tpu.data.datasets import build_durlar_upsampling_dataset
    cfg, params, _ = setup
    _durlar_folder(str(tmp_path), 6)
    data_args = types.SimpleNamespace(
        img_size_low_res=[16, 256], img_size_high_res=[64, 256],
        log_transform=True, roll=False, data_path_low_res=str(tmp_path),
        data_path_high_res=str(tmp_path))
    loader = DataLoader(build_durlar_upsampling_dataset(True, data_args),
                        batch_size=2)
    model = TT.TULIP(model_config("tulip_base", **KW))
    load_jax_params(model, params)
    step = TS.make_train_step(model, TS.make_optimizer(model, WD),
                              compute_dtype=torch.float32)
    seen = []

    def recording_step(low, high, lr, generator):
        assert low.shape == (2, 1, 16, 256) and high.shape == (2, 1, 64, 256)
        assert isinstance(generator, torch.Generator)
        seen.append(lr)
        return step(low, high, lr, generator)

    writer, args = _Writer(), _args()
    stats = TE.train_one_epoch(recording_step, loader, 1,
                               device=torch.device("cpu"), log_writer=writer,
                               args=args)
    want = [lr_at_epoch(i / 3 + 1, 5e-4, 0.0, 2, 4) for i in range(3)]
    assert seen == want
    assert want == [jax_lr_at_epoch(i / 3 + 1, 5e-4, 0.0, 2, 4)
                    for i in range(3)]
    assert [(t, s) for t, _, s in writer.scalars] == [
        (tag, step) for step in (1000, 1333, 1666)
        for tag in ("train_loss_total", "train_loss_pixel", "lr")]
    assert np.isfinite(stats["loss"])
    assert stats["lr"] == pytest.approx(np.mean(want))   # the meter's mean


def test_train_one_epoch_lr_and_tb_gates_with_accum_iter():
    """accum_iter 2: the LR is recomputed on even steps only, and the TB
    scalars are written after odd steps only."""
    batch = ({"sample": np.zeros((1, 1, 16, 256), np.float32)},
             {"sample": np.zeros((1, 1, 64, 256), np.float32)})
    seen = []

    def fake_step(low, high, lr, generator):
        seen.append(lr)
        return torch.tensor(0.5), torch.tensor(0.25)

    writer = _Writer()
    TE.train_one_epoch(fake_step, [batch] * 4, 0, device="cpu",
                       log_writer=writer, args=_args(accum_iter=2))
    lrs = [lr_at_epoch(i / 4, 5e-4, 0.0, 2, 4) for i in (0, 2)]
    assert seen == [lrs[0], lrs[0], lrs[1], lrs[1]]
    assert sorted({s for _, _, s in writer.scalars}) == [250, 750]


def test_train_one_epoch_exits_on_a_nan_loss():
    batch = ({"sample": np.zeros((1, 1, 16, 256), np.float32)},
             {"sample": np.zeros((1, 1, 64, 256), np.float32)})
    nan = lambda *a: (torch.tensor(float("nan")), torch.tensor(0.0))
    with pytest.raises(SystemExit) as e:
        TE.train_one_epoch(nan, [batch] * 2, 0, device="cpu", args=_args())
    assert e.value.code == 1


# ---------------------------------------------------------------------------
# --pin_mem / --no_pin_mem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,want", [([], True), (["--pin_mem"], True),
                                        (["--no_pin_mem"], False)])
def test_pin_mem_flag_reaches_the_engine(monkeypatch, flags, want):
    """The parsed flag is what train_one_epoch hands to batch_to_device for
    both tensors of every batch."""
    from tulip_tpu_torch.config import get_args_parser
    args = get_args_parser().parse_args(
        ["--epochs", "4", "--warmup_epochs", "2", "--lr", "5e-4", *flags])
    assert args.pin_mem is want
    seen = []
    orig = TE.batch_to_device

    def recording(array, device, pin_mem):
        seen.append(pin_mem)
        return orig(array, device, pin_mem)

    monkeypatch.setattr(TE, "batch_to_device", recording)
    batch = ({"sample": np.zeros((1, 1, 16, 256), np.float32)},
             {"sample": np.zeros((1, 1, 64, 256), np.float32)})
    step = lambda low, high, lr, g: (torch.tensor(0.5), torch.tensor(0.25))
    TE.train_one_epoch(step, [batch] * 2, 0, device="cpu", args=args)
    assert seen == [want] * 4


def test_batch_to_device_on_the_cpu_copies_nothing_and_pins_nothing():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)[:, ::2]   # strided
    for pin in (True, False):
        t = TE.batch_to_device(a, "cpu", pin)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert not t.is_pinned()
        np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))
    # a device that is neither the CPU nor CUDA takes the plain copy
    assert TE.batch_to_device(a, "meta", True).device.type == "meta"


def test_no_pin_mem_gives_the_same_first_step_loss_on_the_cpu(setup):
    cfg, params, batches = setup
    low, high = batches[0]
    batch = ({"sample": low}, {"sample": high})
    losses = {}
    for pin in (True, False):
        model = TT.TULIP(model_config("tulip_base", **KW))
        load_jax_params(model, params)
        step = TS.make_train_step(model, TS.make_optimizer(model, WD),
                                  compute_dtype=torch.float32)
        got = []

        def recording_step(x, t, lr, generator):
            out = step(x, t, lr, generator)
            got.append(out[0].item())
            return out

        TE.train_one_epoch(recording_step, [batch], 0, device="cpu",
                           args=_args(pin_mem=pin))
        losses[pin] = got[0]
    assert np.isfinite(losses[True]) and losses[True] == losses[False]
