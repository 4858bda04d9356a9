"""The whole port (tulip_tpu_torch.models.tulip) against the JAX package:
full-depth TULIP-base at 32x256 -> 128x256, batch 2, both packages built
from one JAX ``init_params(PRNGKey(0))`` (loaded into the port with
``load_jax_params``, strict).

- fp32: pred, loss and pixel_loss against JAX apply_model(float32) on the
  XLA path, <= 1e-4 relative (summation order only).
- bf16: pred against JAX bf16 with attn_impl="grouped" (exact softmax,
  tanh-GELU), <= 2e-2 of max|ref|.
"""

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
from tulip_tpu_torch.utils.checkpoint import load_jax_params

KW = dict(img_size=(32, 256), target_img_size=(128, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True)


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


@pytest.mark.parametrize("flag", ["swin_v2", "pixel_shuffle",
                                  "patch_unmerging"])
def test_unported_configs_raise(flag):
    kw = dict(KW)
    kw[flag] = not kw.get(flag, False)
    with pytest.raises(NotImplementedError):
        TT.tulip_base(**kw)


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
