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
from tulip_tpu_torch.models.layers import wide
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


# -- the launch plan of the kernels (ops/ln.py:ln_plan), walked on the CPU --

def _norm1_shapes(model, batch):
    """(N, C) of norm1 at each stage of the 32x2048 step: the patch grid
    (32, 512) halved per stage, C = embed_dim doubled."""
    cfg = model_config(model, (32, 2048), (128, 2048))
    return [(batch * (32 >> s) * (512 >> s), cfg.embed_dim << s)
            for s in range(len(cfg.depths))]


PLAN_SHAPES = sorted(
    {nc for model in ("tulip_base", "tulip_large") for batch in (8, 1)
     for nc in _norm1_shapes(model, batch)}
    | {(131067, 96), (4099, 96), (1001, 72), (333, 40), (7, 1536),
       (1, 8), (513, 768), (2047, 192)})


def _walk(plan, N):
    """Rows in the order the kernels visit them: CTA i's range, its warp w
    taking the row groups w, w + 8, ... of it (fp32: one row a warp)."""
    rows, rpc = plan["rows"], plan["rows_per_cta"]
    order = []
    for c in range(plan["ctas"]):
        r0, r1 = c * rpc, min(N, (c + 1) * rpc)
        assert r0 < r1
        for w in range(8):
            base = np.arange(r0 + w * rows, r1, 8 * rows)
            r = (base[:, None] + np.arange(rows)[None, :]).ravel()
            order.append(r[r < r1])
    return np.concatenate(order)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N,C", PLAN_SHAPES)
def test_ln_plan_covers_every_row_once(N, C, dtype, backward):
    """Every row once, CTA ranges contiguous, disjoint and in order; every
    16-byte chunk of a row held by one lane of its group; the grid and the
    partials within what the kernels were built for."""
    p = TL.ln_plan(N, C, getattr(torch, dtype), backward=backward)
    assert p == TL.ln_plan(N, C, getattr(torch, dtype), backward=backward)
    seen = np.bincount(_walk(p, N), minlength=N)
    assert seen.shape == (N,) and (seen == 1).all()
    rpc, ctas = p["rows_per_cta"], p["ctas"]
    assert (ctas - 1) * rpc < N <= ctas * rpc and rpc % p["rows"] == 0
    assert p["part"] == ((ctas, 2 * C) if backward else None)
    if dtype == "float32":
        assert p["lanes"] == 32 and p["rows"] == 1
        return
    L, cpl, chunks = p["lanes"], p["cpl"], C // 8
    assert L & (L - 1) == 0 and L * p["rows"] == 32 and cpl <= TL._MAX_CPL
    held = sorted(s + k * L for s in range(L) for k in range(cpl)
                  if s + k * L < chunks)
    assert held == list(range(chunks))
    assert ctas <= TL._blocks_per_sm(cpl) * TL.NUM_SMS
    if backward:
        # every CTA in one group of the ordered sum, every group in the
        # final one, and the counters within the workspace's
        group = p["group"]
        n_groups = -(-ctas // group)
        assert p["gpart"] == (n_groups, 2 * C)
        assert (n_groups - 1) * group < ctas <= n_groups * group
        assert 1 + n_groups <= TL._TICKETS


def test_ln_plan_step_shapes():
    """At the flagship's widths each lane holds three chunks, L = C / 24,
    and TULIP-large's C 1,536 six; widths the bf16 kernels do not take
    raise, fp32 takes any."""
    for C, L in ((96, 4), (192, 8), (384, 16), (768, 32)):
        p = TL.ln_plan(8 * 4096, C, torch.bfloat16)
        assert (p["lanes"], p["cpl"], p["rows"]) == (L, 3, 32 // L)
    assert TL.ln_plan(512, 1536, torch.bfloat16)["cpl"] == 6
    for C in (100, 1544, 2048):
        with pytest.raises(NotImplementedError):
            TL.ln_plan(64, C, torch.bfloat16)
        assert TL.ln_plan(64, C, torch.float32)["kernel"] == "warp"


def _replay_bwd(x, w, g, eps, plan):
    """ln_bwd_reg_kernel's arithmetic in torch, fp32: dx by the closed
    form, and dw / db summed in the kernel's order: each lane over the rows
    it visits in order, the warp's row groups by the xor butterfly, the
    CTA's warps in warp order into one (2, C) partial, the partials of each
    group of plan["group"] CTAs in CTA order, then the group sums in group
    order."""
    N, C = x.shape
    x32, g32, w32 = wide(x), wide(g), w.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + eps)
    xh = (x32 - mean) * rstd
    t = g32 * w32
    m1, m2 = t.mean(-1, keepdim=True), (t * xh).mean(-1, keepdim=True)
    dx = (rstd * (t - m1 - xh * m2)).to(x.dtype)
    terms = torch.cat([g32 * xh, g32], 1)             # (N, 2C)
    R, rpc = plan["rows"], plan["rows_per_cta"]
    parts = []
    for c in range(plan["ctas"]):
        r0, r1 = c * rpc, min(N, (c + 1) * rpc)
        cta = None
        for wp in range(8):
            lanes = torch.zeros(R, 2 * C)                 # one per row group
            for base in range(r0 + wp * R, r1, 8 * R):
                rows = torch.arange(base, base + R)
                lanes = lanes + torch.where((rows < r1)[:, None],
                                            terms[rows.clamp(max=N - 1)], 0.)
            o = 1
            while o < R:                                  # xor offsets >= L
                lanes = lanes + lanes[torch.arange(R) ^ o]
                o *= 2
            cta = lanes[0] if cta is None else cta + lanes[0]
        parts.append(cta)
    group = plan["group"]
    sums = []
    for g0 in range(0, len(parts), group):
        acc = torch.zeros(2 * C)
        for part in parts[g0:g0 + group]:
            acc = acc + part
        sums.append(acc)
    acc = torch.zeros(2 * C)
    for part in sums:
        acc = acc + part
    return dx, acc[:C], acc[C:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,C", [(4099, 96), (2047, 192), (513, 768),
                                 (1001, 72)])
def test_bwd_summation_order_matches_plain_and_jax(N, C, dtype):
    """The replay of the kernel's summation order against
    layer_norm_bwd_ref (fp32, 1e-5 of max) and the JAX layer_norm_vjp in
    interpret mode (1e-5 fp32, 2e-2 bf16); two replays give the same
    bits."""
    x, w, b, g = _case(N, C, seed=N)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    xt, gt, wt = (torch.from_numpy(x).to(td), torch.from_numpy(g).to(td),
                  torch.from_numpy(w))
    plan = TL.ln_plan(N, C, torch.bfloat16, backward=True)
    assert plan["ctas"] > plan["group"] > 1
    got = _replay_bwd(xt, wt, gt, EPS, plan)
    assert all(torch.equal(a, b_) for a, b_ in
               zip(got, _replay_bwd(xt, wt, gt, EPS, plan)))
    if dtype == "float32":
        ref = TL.layer_norm_bwd_ref(xt, wt, gt, EPS)
        for a, r in zip(got, ref):
            assert _rel(a.numpy(), r.numpy()) <= 1e-5
    _, vjp = jax.vjp(lambda x_, w_, b_: layer_norm_vjp(x_, w_, b_, EPS),
                     jnp.asarray(x).astype(jd), jnp.asarray(w).reshape(1, -1),
                     jnp.asarray(b).reshape(1, -1))
    jdx, jdw, jdb = vjp(jnp.asarray(g).astype(jd))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    tol = TOL[dtype]
    assert _rel(got[0].float().numpy(), f32(jdx)) <= tol
    assert _rel(got[1].numpy(), f32(jdw)[0]) <= tol
    assert _rel(got[2].numpy(), f32(jdb)[0]) <= tol
