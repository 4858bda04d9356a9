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
    taking the row groups w, w + 8, ... of it (the fp32 one-warp-a-row
    form and 32 lanes a row: one row a group)."""
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


def _check_grid(p, N, C, backward):
    """Every row once in the kernels' walk, CTA ranges contiguous, disjoint
    and in order; the grid and the partials within what the kernels were
    built for."""
    seen = np.bincount(_walk(p, N), minlength=N)
    assert seen.shape == (N,) and (seen == 1).all()
    rpc, ctas = p["rows_per_cta"], p["ctas"]
    assert (ctas - 1) * rpc < N <= ctas * rpc and rpc % p["rows"] == 0
    assert p["part"] == ((ctas, TL._stride(C)) if backward else None)
    assert ctas <= TL._blocks_per_sm(p["cpl"]) * TL.NUM_SMS
    if backward:
        # every CTA in one group of the ordered sum, every group in the
        # final one, and the counters within the workspace's
        group = p["group"]
        n_groups = -(-ctas // group)
        assert p["gpart"] == (n_groups, TL._stride(C))
        assert (n_groups - 1) * group < ctas <= n_groups * group
        assert 1 + n_groups <= TL._TICKETS


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N,C", PLAN_SHAPES)
def test_ln_plan_covers_every_row_once(N, C, dtype, backward):
    """The register form in both types: every row once, CTA ranges
    contiguous, disjoint and in order; every 16-byte chunk of a row (8 bf16
    or 4 fp32 values) held by one lane of its group; the grid and the
    partials within what the kernels were built for."""
    td = getattr(torch, dtype)
    p = TL.ln_plan(N, C, td, backward=backward)
    assert p == TL.ln_plan(N, C, td, backward=backward)
    assert p["kernel"] == "reg"
    _check_grid(p, N, C, backward)
    L, cpl, chunks = p["lanes"], p["cpl"], C // TL._CHUNK[td]
    assert C % TL._CHUNK[td] == 0 and TL._stride(C) == 2 * C
    assert L & (L - 1) == 0 and L * p["rows"] == 32
    assert cpl <= TL._MAX_CPL[td] and (cpl <= TL._REG_CPL or L == 32)
    held = sorted(s + k * L for s in range(L) for k in range(cpl)
                  if s + k * L < chunks)
    assert held == list(range(chunks))


# fp32 widths off the register form: not whole 16-byte chunks, or above
# 1,536
ROW_SHAPES = [(64, 1544), (333, 2048), (4099, 98), (7, 3), (1, 1),
              (513, 1540), (131067, 6)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N,C", ROW_SHAPES)
def test_ln_plan_f32_any_width_covers_every_row_once(N, C, backward):
    """fp32 widths the register form does not take run one warp a row
    (ln_*_row_f32_kernel): the same walk, every row once, the partial rows
    padded to whole float4; bf16 refuses them."""
    p = TL.ln_plan(N, C, torch.float32, backward=backward)
    assert p == TL.ln_plan(N, C, torch.float32, backward=backward)
    assert (p["kernel"], p["lanes"], p["cpl"], p["rows"]) == ("row", 32,
                                                              None, 1)
    _check_grid(p, N, C, backward)
    assert TL._stride(C) % 4 == 0 and 0 <= TL._stride(C) - 2 * C < 4
    with pytest.raises(NotImplementedError):
        TL.ln_plan(N, C, torch.bfloat16, backward=backward)


def _form(C, dtype):
    p = TL.ln_plan(8 * 4096, C, dtype)
    return p["kernel"], p["lanes"], p["cpl"]


def test_ln_plan_step_shapes():
    """At the flagship's widths each bf16 lane holds three chunks, L = C /
    24, and TULIP-large's C 1,536 six; widths the bf16 kernels do not take
    raise.  fp32 takes every width: the register form at the flagship's
    (three chunks a lane, C 768 six), TULIP-large's C 1,536 (twelve: the
    wide instantiation, sums in shared memory), C 100, 72 and 40 (whole
    chunks, not whole lanes); one warp a row at C 1,544, 2,048 and widths
    that are not whole chunks."""
    for C, L in ((96, 4), (192, 8), (384, 16), (768, 32)):
        p = TL.ln_plan(8 * 4096, C, torch.bfloat16)
        assert (p["lanes"], p["cpl"], p["rows"]) == (L, 3, 32 // L)
    assert TL.ln_plan(512, 1536, torch.bfloat16)["cpl"] == 6
    for C in (100, 1544, 2048):
        with pytest.raises(NotImplementedError):
            TL.ln_plan(64, C, torch.bfloat16)
    f32 = {C: _form(C, torch.float32) for C in
           (96, 192, 384, 768, 1536, 100, 72, 40, 1544, 2048, 98, 3)}
    assert f32 == {96: ("reg", 8, 3), 192: ("reg", 16, 3),
                   384: ("reg", 32, 3), 768: ("reg", 32, 6),
                   1536: ("reg", 32, 12), 100: ("reg", 8, 4),
                   72: ("reg", 4, 5), 40: ("reg", 2, 5),
                   1544: ("row", 32, None), 2048: ("row", 32, None),
                   98: ("row", 32, None), 3: ("row", 32, None)}
    # every width a configuration of the JAX package reaches takes the
    # register form: the stages' widths, which norm1, the post-norms,
    # PatchExpanding (half the width it expands) / FinalPatchExpanding /
    # norm_up and the classifier's merges and final norm all take
    for model in ("tulip_base", "tulip_large"):
        cfg = model_config(model, (32, 2048), (128, 2048))
        for s in range(len(cfg.depths)):
            assert _form(cfg.embed_dim << s, torch.float32)[0] == "reg"


def _replay_bwd(x, w, g, eps, plan):
    """ln_bwd_reg_kernel's arithmetic in torch, fp32: dx by the closed
    form, and dw / db summed in the kernel's order: each lane over the rows
    it visits in order, the warp's row groups by the xor butterfly, the
    CTA's warps in warp order into one (2, C) partial, the partials of each
    group of plan["group"] CTAs in CTA order, then the group sums in group
    order.  The fp32 wide instantiations (sums in shared memory) and
    ln_bwd_row_f32_kernel take one row a warp at a time (no butterfly) in
    the same order."""
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
    plan = TL.ln_plan(N, C, td, backward=True)
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


@pytest.mark.parametrize("N,C,kernel,cpl", [(1001, 1536, "reg", 12),
                                            (333, 1544, "row", None),
                                            (1001, 98, "row", None)])
def test_bwd_summation_order_f32_wide_and_row(N, C, kernel, cpl):
    """The fp32 forms past three chunks a lane's registers: the wide
    register instantiation at TULIP-large's C 1,536 (dw / db in shared
    memory) and one warp a row at C 1,544 and 98.  The replay of their
    summation order against layer_norm_bwd_ref and the JAX layer_norm_vjp
    in interpret mode, 1e-5 of max|ref|; two replays give the same bits."""
    x, w, b, g = _case(N, C, seed=C)
    xt, gt, wt = (torch.from_numpy(a) for a in (x, g, w))
    plan = TL.ln_plan(N, C, torch.float32, backward=True)
    assert (plan["kernel"], plan["cpl"], plan["rows"]) == (kernel, cpl, 1)
    assert plan["ctas"] > plan["group"] > 1
    got = _replay_bwd(xt, wt, gt, EPS, plan)
    assert all(torch.equal(a, b_) for a, b_ in
               zip(got, _replay_bwd(xt, wt, gt, EPS, plan)))
    for a, r in zip(got, TL.layer_norm_bwd_ref(xt, wt, gt, EPS)):
        assert _rel(a.numpy(), r.numpy()) <= 1e-5
    _, vjp = jax.vjp(lambda x_, w_, b_: layer_norm_vjp(x_, w_, b_, EPS),
                     jnp.asarray(x), jnp.asarray(w).reshape(1, -1),
                     jnp.asarray(b).reshape(1, -1))
    jdx, jdw, jdb = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    assert _rel(got[0].numpy(), jdx) <= TOL["float32"]
    assert _rel(got[1].numpy(), jdw[0]) <= TOL["float32"]
    assert _rel(got[2].numpy(), jdb[0]) <= TOL["float32"]
