"""The whole port (tulip_tpu_torch.models.tulip) against the JAX package:
full-depth TULIP-base at 32x256 -> 128x256, batch 2, both packages built
from one JAX ``init_params(PRNGKey(0))`` (loaded into the port with
``load_jax_params``, strict).

- fp32: pred, loss and pixel_loss against JAX apply_model(float32) on the
  XLA path, <= 1e-4 relative (summation order only).
- bf16: pred against JAX bf16 with attn_impl="grouped" (exact softmax,
  tanh-GELU), <= 2e-2 of max|ref|.

The forms the port took last (FORMS: in_chans 2 with the pixel-shuffle and
the FinalPatchExpanding head, qkv_bias False with v1 and v2 blocks, set by
``dataclasses.replace`` on both packages' configs) at the two-stage
16x256 -> 64x256 config of test_torch_train.py: the init's keys and
shapes; the fp32 pred and losses within 1e-5 of JAX's (relative to
max|ref|); bf16 within 3e-2 of max|ref| of JAX's attn_impl="grouped"; and
the train-mode loss and every gradient of one step against jax.grad
within test_torch_train.py's limits (loss 1e-5 relative, each gradient
1e-4 of its max|ref|).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.ops import mlp as TM
from tulip_tpu_torch.ops import window_msa as TW
from tulip_tpu_torch.config import model_config as port_config
from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                              load_jax_params,
                                              state_dict_from_jax)

KW = dict(img_size=(32, 256), target_img_size=(128, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True)
# the two-stage TULIP-base of test_torch_train.py, 16x256 -> 64x256
SMALL = dict(KW, img_size=(16, 256), target_img_size=(64, 256),
             depths=(2, 2), num_heads=(3, 6))
# the configurations the port refused before: in_chans 2 with both heads,
# and a bias-free qkv with v1 and v2 blocks
FORMS = {
    "in_chans 2, pixel-shuffle head": (dict(SMALL, in_chans=2), True),
    "in_chans 2, FinalPatchExpanding head": (
        dict(SMALL, in_chans=2, pixel_shuffle=False, patch_unmerging=False),
        True),
    "qkv_bias False, v1": (SMALL, False),
    "qkv_bias False, v2": (dict(SMALL, swin_v2=True), False),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: several test processes share the machine's cores
    (as in test_torch_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    cfg = model_config("tulip_base", **KW)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    model = TT.tulip_base(**KW)
    load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 1, 32, 256)).astype(np.float32)
    t = rng.uniform(0, 1, (2, 1, 128, 256)).astype(np.float32)
    return cfg, params, model, x, t


def _launches():
    return (TW.window_msa.launches, TM.fused_two_matmul.launches,
            TM.fused_ln_linear.launches)


def test_fp32_matches_jax(pair):
    cfg, params, model, x, t = pair
    jpred, jloss, jploss = JT.apply_model(
        params, JT.build_model(cfg), jnp.asarray(x), jnp.asarray(t),
        mode="eval", compute_dtype=jnp.float32)
    before = _launches()
    pred, loss, ploss = TT.apply_model(model, torch.from_numpy(x),
                                       torch.from_numpy(t), mode="eval")
    assert _launches() == before          # the CPU path launches no kernel
    jpred = np.asarray(jpred)
    assert pred.shape == (2, 1, 128, 256) and pred.dtype == torch.float32
    assert np.abs(pred.numpy() - jpred).max() <= 1e-4 * np.abs(jpred).max()
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert abs(float(ploss) - float(jploss)) <= 1e-4 * abs(float(jploss))


def test_bf16_matches_jax_grouped(pair):
    cfg, params, model, x, _ = pair
    jcfg = model_config("tulip_base", attn_impl="grouped", **KW)
    jpred = JT.apply_model(params, JT.build_model(jcfg), jnp.asarray(x),
                           mode="mc", mc_drop=True,
                           compute_dtype=jnp.bfloat16)
    jpred = np.asarray(jpred.astype(jnp.float32))
    m16 = TT.tulip_base(**KW)
    m16.load_state_dict(model.state_dict(), strict=True)
    m16 = m16.to(torch.bfloat16)
    pred = TT.apply_model(m16, torch.from_numpy(x), mode="mc", mc_drop=True,
                          compute_dtype=torch.bfloat16)
    assert pred.dtype == torch.bfloat16
    err = np.abs(pred.float().numpy() - jpred).max() / np.abs(jpred).max()
    assert err <= 2e-2, err


def test_apply_model_arity_and_modes(pair):
    _, _, model, x, t = pair
    xt = torch.from_numpy(x[:1])
    pred = TT.apply_model(model, xt, mode="mc", mc_drop=True)
    assert isinstance(pred, torch.Tensor) and pred.shape == (1, 1, 128, 256)
    out = TT.apply_model(model, xt, torch.from_numpy(t[:1]))
    assert len(out) == 3 and out[1].ndim == 0 and out[2].ndim == 0
    torch.testing.assert_close(out[0], pred)
    assert not out[1].requires_grad       # eval runs without autograd
    # train mode: autograd on, a loss whose backward reaches the weights
    _, loss, _ = TT.apply_model(model, xt, torch.from_numpy(t[:1]),
                                mode="train")
    assert loss.requires_grad and loss.ndim == 0
    loss.backward()
    grad = model.layers[0].blocks[1].attn.relative_position_bias_table.grad
    assert grad is not None and bool(grad.abs().sum() > 0)
    model.zero_grad(set_to_none=True)


def test_in_chans_other_than_one_raises():
    """in_chans 2 builds, and its model takes two channels only: a
    one-channel scan raises in the patch embed's matmul, a two-channel one
    gives two channels out (the folded head predicts in_chans)."""
    kw = dict(SMALL, in_chans=2)
    model = TT.tulip_base(**kw)
    model.load_state_dict(TT.init_params(model.cfg,
                                         torch.Generator().manual_seed(0)),
                          strict=True)
    with pytest.raises(RuntimeError):
        TT.apply_model(model, torch.rand(1, 1, 16, 256), mode="mc",
                       mc_drop=True)
    pred = TT.apply_model(model, torch.rand(1, 2, 16, 256), mode="mc",
                          mc_drop=True)
    assert pred.shape == (1, 2, 64, 256) and bool(torch.isfinite(pred).all())


def test_forward_loss_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.normal(0, 0.5, (2, 1, 8, 16)).astype(np.float32)
    t = rng.normal(0, 0.5, (2, 1, 8, 16)).astype(np.float32)
    for log in (False, True):
        ours = TT.forward_loss(torch.from_numpy(p), torch.from_numpy(t), log)
        ref = JT.forward_loss(jnp.asarray(p), jnp.asarray(t), log)
        np.testing.assert_allclose([float(v) for v in ours],
                                   [float(v) for v in ref], rtol=1e-6)


def test_tulip_large_builds_and_runs():
    """Five stages (48 heads at the bottleneck) from the port's own init."""
    kw = dict(KW, img_size=(32, 512), target_img_size=(128, 512))
    model = TT.tulip_large(**kw)
    model.load_state_dict(TT.init_params(model.cfg,
                                         torch.Generator().manual_seed(0)),
                          strict=True)
    pred = TT.apply_model(model, torch.rand(1, 1, 32, 512), mode="mc",
                          mc_drop=True)
    assert pred.shape == (1, 1, 128, 512) and bool(torch.isfinite(pred).all())


@pytest.mark.parametrize("flag,entry,calls", [
    ("TULIP_TPU_MSA_GROUPED", "window_msa_grouped", 14),
    ("TULIP_TPU_MSA_NAT", "window_msa_nat", 6)])
def test_layout_flags_give_the_default_pred(pair, monkeypatch, flag, entry,
                                            calls):
    """With TULIP_TPU_MSA_GROUPED=1 all 14 blocks go through the grouped
    entry, with TULIP_TPU_MSA_NAT=1 the 6 blocks with more than 8 heads
    through the natural one; the pred is the default path's (fp32, 1e-5 of
    max: the same arithmetic per window, other reshapes around it)."""
    from tulip_tpu_torch.models import swin
    _, _, model, x, _ = pair
    xt = torch.from_numpy(x)
    for k in ("TULIP_TPU_MSA_GROUPED", "TULIP_TPU_MSA_NAT",
              "TULIP_TPU_MSA_MASKED"):
        monkeypatch.delenv(k, raising=False)
    ref = TT.apply_model(model, xt, mode="mc", mc_drop=True)
    seen = {"window_msa": 0, "window_msa_grouped": 0, "window_msa_nat": 0}
    for name in seen:
        orig = getattr(swin, name)
        monkeypatch.setattr(swin, name, lambda *a, _n=name, _o=orig, **kw: (
            seen.__setitem__(_n, seen[_n] + 1), _o(*a, **kw))[1])
    monkeypatch.setenv(flag, "1")
    pred = TT.apply_model(model, xt, mode="mc", mc_drop=True)
    assert seen[entry] == calls and sum(seen.values()) == 14
    assert float((pred - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_layout_dispatch_follows_the_jax_rules(monkeypatch):
    """swin.py:496-498: NAT wins over GROUPED; with NAT the head-count
    cutover (8, or TULIP_TPU_MSA_MASKED) keeps the small-head blocks on the
    default path."""
    from tulip_tpu_torch.models.swin import msa_layout
    for k in ("TULIP_TPU_MSA_GROUPED", "TULIP_TPU_MSA_NAT",
              "TULIP_TPU_MSA_MASKED"):
        monkeypatch.delenv(k, raising=False)
    assert [msa_layout(n) for n in (3, 6, 12, 24)] == ["default"] * 4
    monkeypatch.setenv("TULIP_TPU_MSA_GROUPED", "1")
    assert [msa_layout(n) for n in (3, 6, 12, 24)] == ["grouped"] * 4
    monkeypatch.setenv("TULIP_TPU_MSA_NAT", "1")
    assert [msa_layout(n) for n in (3, 6, 12, 24)] == \
        ["default", "default", "nat", "nat"]
    monkeypatch.setenv("TULIP_TPU_MSA_MASKED", "3")
    assert [msa_layout(n) for n in (3, 6, 12, 24)] == \
        ["default", "nat", "nat", "nat"]
    monkeypatch.setenv("TULIP_TPU_MSA_MASKED", "0")
    assert [msa_layout(n) for n in (3, 6)] == ["nat", "nat"]


# ---------------------------------------------------------------------------
# in_chans 2 and a bias-free qkv
# ---------------------------------------------------------------------------

def _form(name, **extra):
    """(JAX cfg, port model with the JAX weights, JAX params, x, target)
    of one FORMS entry, batch 2."""
    kw, qkv_bias = FORMS[name]
    kw = dict(kw, **extra)
    jcfg = dataclasses.replace(model_config("tulip_base", **kw),
                               qkv_bias=qkv_bias)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    params = {k: np.asarray(v) for k, v in params.items()}
    model = TT.TULIP(dataclasses.replace(port_config("tulip_base", **kw),
                                         qkv_bias=qkv_bias))
    load_jax_params(model, params)
    c = jcfg.in_chans
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, c, 16, 256)).astype(np.float32)
    t = rng.uniform(0, 1, (2, c, 64, 256)).astype(np.float32)
    return jcfg, model, params, x, t


@pytest.mark.parametrize("name", list(FORMS))
def test_form_init_matches_jax_keys_and_shapes(name):
    kw, qkv_bias = FORMS[name]
    cfg = dataclasses.replace(port_config("tulip_base", **kw),
                              qkv_bias=qkv_bias)
    ours = TT.init_params(cfg, torch.Generator().manual_seed(0))
    theirs = state_dict_from_jax({k: np.asarray(v) for k, v in JT.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(
            model_config("tulip_base", **kw), qkv_bias=qkv_bias)).items()})
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
    assert any(k.endswith(("qkv.bias", "q_bias", "v_bias"))
               for k in ours) == qkv_bias
    assert ours["decoder_pred.weight"].shape[0] == cfg.in_chans
    TT.TULIP(cfg).load_state_dict(ours, strict=True)


@pytest.mark.parametrize("name", list(FORMS))
def test_form_fp32_matches_jax(name):
    jcfg, model, params, x, t = _form(name)
    jpred, jloss, jploss = JT.apply_model(
        {k: jnp.asarray(v) for k, v in params.items()}, JT.build_model(jcfg),
        jnp.asarray(x), jnp.asarray(t), mode="eval",
        compute_dtype=jnp.float32)
    before = _launches()
    pred, loss, ploss = TT.apply_model(model, torch.from_numpy(x),
                                       torch.from_numpy(t), mode="eval")
    assert _launches() == before
    jpred = np.asarray(jpred)
    assert pred.shape == jpred.shape == t.shape
    assert np.abs(pred.numpy() - jpred).max() <= 1e-5 * np.abs(jpred).max()
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(ploss) - float(jploss)) <= 1e-5 * abs(float(jploss))


@pytest.mark.parametrize("name", list(FORMS))
def test_form_bf16_matches_jax_grouped(name):
    jcfg, model, params, x, _ = _form(name, attn_impl="grouped")
    jpred = JT.apply_model({k: jnp.asarray(v) for k, v in params.items()},
                           JT.build_model(jcfg), jnp.asarray(x), mode="mc",
                           mc_drop=True, compute_dtype=jnp.bfloat16)
    jpred = np.asarray(jpred.astype(jnp.float32))
    pred = TT.apply_model(model.to(torch.bfloat16), torch.from_numpy(x),
                          mode="mc", mc_drop=True,
                          compute_dtype=torch.bfloat16)
    assert pred.dtype == torch.bfloat16 and pred.shape == jpred.shape
    err = np.abs(pred.float().numpy() - jpred).max() / np.abs(jpred).max()
    assert err <= 3e-2, err


@pytest.mark.parametrize("name", ["qkv_bias False, v1",
                                  "in_chans 2, pixel-shuffle head"])
def test_form_train_step_gradients_match_jax(name):
    jcfg, model, params, x, t = _form(name, drop_path_rate=0.0)
    jmodel = JT.build_model(jcfg)

    def loss_fn(p):
        _, total, _ = JT.apply_model(p, jmodel, jnp.asarray(x),
                                     jnp.asarray(t), mode="train",
                                     rng=jax.random.PRNGKey(1),
                                     compute_dtype=jnp.float32)
        return total

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in params.items()})
    _, total, _ = TT.apply_model(model, torch.from_numpy(x),
                                 torch.from_numpy(t), mode="train")
    total.backward()
    assert abs(total.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = jax_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    assert set(grads) == set(jgrads)
    errs = {k: float(np.abs(grads[k] - np.asarray(jgrads[k])).max()
                     / np.abs(np.asarray(jgrads[k])).max()) for k in grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])
