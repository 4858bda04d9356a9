"""The port's fused two-matmul and LN + matmul (tulip_tpu_torch.ops.mlp)
against the JAX package's Pallas kernels in interpret mode on the CPU:
mlp.py:_kernel (K3) through fused_ln_mlp and the folded head
tulip._ps_head_pred_fused, and mlp.py:_kernel_ln_mm (K4) through
fused_ln_linear.

Limits relative to max|ref|: 1e-4 in fp32, 2e-2 in bf16.  The JAX bf16 MLP
defaults to a sigmoid GELU; these tests set TULIP_TPU_GELU_TANH=1 for its
tanh form, which is within 3e-3 of the exact erf GELU the port uses."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu.ops.pallas import mlp as JM
from tulip_tpu_torch.ops import mlp as TM

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rel(out, ref):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return np.abs(out - ref).max() / np.abs(ref).max()


def _ln(rng, C):
    return (rng.normal(1, 0.1, (C,)).astype(np.float32),
            rng.normal(0, 0.1, (C,)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,C", [(256, 96), (128, 192)])
def test_ln_mlp_matches_jax_pallas(monkeypatch, dtype, N, C):
    monkeypatch.setenv("TULIP_TPU_GELU_TANH", "1")
    rng = np.random.default_rng(0)
    f = np.float32
    x = rng.normal(0, 1, (N, C)).astype(f)
    lnw, lnb = _ln(rng, C)
    w1 = (rng.normal(size=(C, 4 * C)) * C ** -0.5).astype(f)      # (in, out)
    b1 = (rng.normal(size=(4 * C,)) * 0.1).astype(f)
    w2 = (rng.normal(size=(4 * C, C)) * (4 * C) ** -0.5).astype(f)
    b2 = (rng.normal(size=(C,)) * 0.1).astype(f)
    jd = JD[dtype]
    j = lambda a: jnp.asarray(a).astype(jd)
    ref = JM.fused_ln_mlp(j(x), j(lnw)[None], j(lnb)[None], j(w1),
                          j(b1)[None], j(w2), j(b2)[None], eps=1e-6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype))
    out = TM.fused_ln_mlp(t(x), t(lnw), t(lnb), t(w1.T), t(b1), t(w2.T),
                          t(b2), eps=1e-6)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_matmul_without_ln_matches_jax_pallas(dtype):
    """lnw=None: no LayerNorm, leaky activation, no residual."""
    rng = np.random.default_rng(4)
    f = np.float32
    N, C, Hd, O = 128, 96, 384, 16
    x = rng.normal(0, 1, (N, C)).astype(f)
    w1 = (rng.normal(size=(C, Hd)) * C ** -0.5).astype(f)          # (in, out)
    b1 = (rng.normal(size=(Hd,)) * 0.1).astype(f)
    w2 = (rng.normal(size=(Hd, O)) * Hd ** -0.5).astype(f)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(f)
    jd = JD[dtype]
    j = lambda a: jnp.asarray(a).astype(jd)
    ref = JM.fused_two_matmul(j(x), None, None, j(w1), j(b1)[None], j(w2),
                              j(b2)[None], act="leaky", residual=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype))
    out = TM.fused_two_matmul(t(x), None, None, t(w1.T), t(b1), t(w2.T),
                              t(b2), act="leaky", residual=False)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_jax_pallas(dtype):
    """norm_up + ps_head + decoder_pred, folded into one two-matmul in both
    packages (the port through TULIP._head)."""
    from tulip_tpu_torch.models.tulip import tulip_base
    from tulip_tpu_torch.utils.checkpoint import state_dict_from_jax
    kw = dict(img_size=(32, 256), target_img_size=(128, 256),
              patch_size=(1, 4), window_size=(2, 8), pixel_shuffle=True,
              circular_padding=True, log_transform=True,
              patch_unmerging=True)
    cfg = model_config("tulip_base", **kw)
    rng = np.random.default_rng(1)
    f = np.float32
    C, r2 = 96, 16
    lnw, lnb = _ln(rng, C)
    p = {"norm_up.weight": lnw, "norm_up.bias": lnb,
         "ps_head.conv_expand.0.weight":
             (rng.normal(size=(1, 1, C, C * r2)) * C ** -0.5).astype(f),
         "ps_head.conv_expand.0.bias":
             (rng.normal(size=(C * r2,)) * 0.1).astype(f),
         "decoder_pred.weight":
             (rng.normal(size=(1, 1, C, 1)) * C ** -0.5).astype(f)}
    x = rng.normal(0, 1, (2, 4, 8, C)).astype(f)
    jd = JD[dtype]
    ref = JT._ps_head_pred_fused({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x).astype(jd), cfg,
                                 with_norm_up=True)
    model = tulip_base(**kw)
    sd = state_dict_from_jax(p)
    assert set(sd) <= set(model.state_dict())
    model.load_state_dict(sd, strict=False)
    model = model.to(getattr(torch, dtype))
    out = model._head(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.shape == (2, 16, 32, 1)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K", [(128, 384), (64, 768), (32, 1536)])
def test_ln_linear_matches_jax_pallas(dtype, N, K):
    rng = np.random.default_rng(2)
    f = np.float32
    x = rng.normal(0, 1, (N, K)).astype(f)
    lnw, lnb = _ln(rng, K)
    w = (rng.normal(size=(K, K // 2)) * K ** -0.5).astype(f)        # (in, out)
    jd = JD[dtype]
    j = lambda a: jnp.asarray(a).astype(jd)
    ref = JM.fused_ln_linear(j(x), j(lnw)[None], j(lnb)[None], j(w), 1e-6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype))
    out = TM.fused_ln_linear(t(x), t(lnw), t(lnb), t(w.T), eps=1e-6)
    assert _rel(out, ref) <= TOL[dtype]


def test_cpu_dispatch_is_the_plain_version():
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, lnw, lnb = t(32, 64), t(64), t(64)
    w1, b1, w2 = t(128, 64), t(128), t(16, 128)
    before = (TM.fused_two_matmul.launches, TM.fused_ln_linear.launches)
    a = TM.fused_two_matmul(x, lnw, lnb, w1, b1, w2, None, act="leaky",
                            residual=False)
    b = TM.fused_two_matmul_ref(x, lnw, lnb, w1, b1, w2, None, act="leaky",
                                residual=False)
    assert torch.equal(a, b)
    w = t(32, 64)
    assert torch.equal(TM.fused_ln_linear(x, lnw, lnb, w),
                       TM.fused_ln_linear_ref(x, lnw, lnb, w))
    assert (TM.fused_two_matmul.launches,
            TM.fused_ln_linear.launches) == before
