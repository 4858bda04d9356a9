"""The port's LayerNorm op (tulip_tpu_torch.ops.ln) against the JAX
package's Pallas LayerNorm with its custom VJP (ops/pallas/ln.py:
layer_norm_vjp, kernels _fwd_kernel and _bwd_kernel in interpret mode on
the CPU), and the training block that takes it with TULIP_TPU_LN_PALLAS=1.

Inputs come from one numpy seed.  Limits are relative to each output's
max|ref|: 1e-5 in fp32 (summation order only), 2e-2 in bf16 (one rounding
of y / dx to bf16 on each side; dw and db are fp32 sums on both)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu.ops.pallas.ln import layer_norm_vjp
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.ops import ln as TL
from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                              load_jax_params)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
EPS = 1e-6


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test processes share the machine's cores; full-width torch
    thread pools in each of them mostly wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _case(N, C, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(0.5, 2.0, (N, C)).astype(f),
            rng.normal(1, 0.1, (C,)).astype(f),
            rng.normal(0, 0.1, (C,)).astype(f),
            rng.normal(0, 1, (N, C)).astype(f))


def _rel(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,C", [(256, 96), (128, 192), (64, 768)])
def test_layer_norm_fn_matches_jax_pallas_vjp(dtype, N, C):
    x, w, b, g = _case(N, C)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    f = lambda x_, w_, b_: layer_norm_vjp(x_, w_, b_, EPS)
    jy, vjp = jax.vjp(f, jnp.asarray(x).astype(jd),
                      jnp.asarray(w).reshape(1, -1),
                      jnp.asarray(b).reshape(1, -1))
    jdx, jdw, jdb = vjp(jnp.asarray(g).astype(jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    before = (TL.ln_fwd.launches, TL.ln_bwd.launches)
    y = TL.layer_norm_fn(xt, wt, bt, EPS)
    y.backward(torch.from_numpy(g).to(td))
    assert (TL.ln_fwd.launches, TL.ln_bwd.launches) == before
    assert y.dtype == td and xt.grad.dtype == td
    assert wt.grad.dtype == bt.grad.dtype == torch.float32
    tol = TOL[dtype]
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    assert _rel(y.detach().float().numpy(), f32(jy)) <= tol
    assert _rel(xt.grad.float().numpy(), f32(jdx)) <= tol
    assert _rel(wt.grad.numpy(), f32(jdw)[0]) <= tol
    assert _rel(bt.grad.numpy(), f32(jdb)[0]) <= tol


def test_backward_is_the_gradient_of_the_forward():
    """The written-out backward against autograd of the plain forward, in
    float64."""
    x, w, b, g = (torch.from_numpy(a).double() for a in _case(32, 96, 1))
    x.requires_grad_(), w.requires_grad_(), b.requires_grad_()
    TL.layer_norm_ref(x, w, b, EPS).backward(g)
    dx, dw, db = TL.layer_norm_bwd_ref(x.detach(), w.detach(), g, EPS)
    torch.testing.assert_close(dx, x.grad, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(dw, w.grad, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(db, b.grad, rtol=1e-9, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda x_, w_, b_: TL.layer_norm_fn(x_, w_, b_, EPS),
        (x.detach()[:4].requires_grad_(), w.detach().requires_grad_(),
         b.detach().requires_grad_()))


def test_cpu_dispatch_and_other_devices():
    x, w, b, g = (torch.from_numpy(a) for a in _case(16, 96, 2))
    assert torch.equal(TL.ln_fwd(x, w, b, EPS), TL.layer_norm_ref(x, w, b, EPS))
    for o, r in zip(TL.ln_bwd(x, w, g, EPS),
                    TL.layer_norm_bwd_ref(x, w, g, EPS)):
        assert torch.equal(o, r)
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TL.ln_fwd(m(16, 96), m(96), m(96))
    with pytest.raises(ValueError, match="cuda"):
        TL.ln_bwd(m(16, 96), m(96), m(16, 96))


KW = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True, depths=(2, 2),
          num_heads=(3, 6))


def _train_grads(monkeypatch, flag):
    """bf16 train-mode loss and gradients of the two-stage model in both
    packages, with TULIP_TPU_LN_PALLAS set to ``flag`` on both sides."""
    if flag:
        monkeypatch.setenv("TULIP_TPU_LN_PALLAS", "1")
    else:
        monkeypatch.delenv("TULIP_TPU_LN_PALLAS", raising=False)
    monkeypatch.setenv("TULIP_TPU_GELU_TANH", "1")
    cfg = model_config("tulip_base", drop_path_rate=0.0, attn_impl="pallas",
                       **KW)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 1, (2, 1, 16, 256)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 1, 64, 256)).astype(np.float32)
    jmodel = JT.build_model(cfg)

    def loss_fn(p):
        return JT.apply_model(p, jmodel, jnp.asarray(low), jnp.asarray(high),
                              mode="train", rng=jax.random.PRNGKey(1),
                              compute_dtype=jnp.bfloat16)[1]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model = TT.TULIP(cfg)
    load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    before = TL.ln_fwd.launches
    calls = []
    orig = TL.LayerNormFn.forward
    monkeypatch.setattr(TL.LayerNormFn, "forward", staticmethod(
        lambda *a: (calls.append(1), orig(*a))[1]))
    _, total, _ = TT.apply_model(model, torch.from_numpy(low),
                                 torch.from_numpy(high), mode="train",
                                 compute_dtype=torch.bfloat16)
    total.backward()
    assert TL.ln_fwd.launches == before      # CPU: the plain version
    grads = jax_params_from_state_dict(
        {k: p.grad for k, p in model.named_parameters()})
    return float(jloss), jgrads, total.item(), grads, len(calls)


@pytest.mark.parametrize("flag", [True, False])
def test_train_block_with_ln_flag_matches_jax(monkeypatch, flag):
    """With the flag norm1 of each of the six blocks goes through
    layer_norm_fn (port) / layer_norm_vjp (JAX); without it through neither.
    bf16 on both sides: loss within 3e-2 relative, the flattened gradients'
    cosine >= 0.99 (the limits of the bf16 whole-step check on the card)."""
    jloss, jgrads, loss, grads, calls = _train_grads(monkeypatch, flag)
    assert calls == (6 if flag else 0)
    assert abs(loss - jloss) <= 3e-2 * abs(jloss)
    a = np.concatenate([grads[k].ravel() for k in sorted(grads)]).astype(np.float64)
    b = np.concatenate([np.asarray(jgrads[k], np.float32).ravel()
                        for k in sorted(grads)]).astype(np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos >= 0.99, cos
