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
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import tulip as JT
from tulip_tpu.ops.pallas import mlp as JM
from tulip_tpu_torch.ops import mlp as TM

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rel(out, ref):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
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


# ---------------------------------------------------------------------------
# Backward: TwoMatmul (K3 forward, K10 backward) and LnLinear (K4, K11)
# against the JAX package's custom VJPs (Pallas in interpret mode, or its
# XLA recompute where _bwd_vmem_ok rejects the shape), with the same limits.
# In bf16 the JAX VJP differentiates the tanh GELU (mlp.py:156-165), the
# port the exact erf GELU its forward computes (< 3e-3 apart per unit,
# inside the 2e-2).
# ---------------------------------------------------------------------------

def _t(a, dtype, grad=True):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return t.requires_grad_() if grad else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mlp", "head", "stage3"])
def test_two_matmul_grads_match_jax_vjp(case, dtype):
    """mlp: GELU with LN and residual, N 256, C 96 (Pallas backward);
    head: leaky, C 96 -> 1536 -> 16, no LN, no residual (Pallas);
    stage3: GELU with LN and residual, N 32, C 768 -> 3072 (JAX's XLA
    recompute fallback)."""
    N, C, Hd, O, act, ln, res = {
        "mlp": (256, 96, 384, 96, "gelu", True, True),
        "head": (128, 96, 1536, 16, "leaky", False, False),
        "stage3": (32, 768, 3072, 768, "gelu", True, True)}[case]
    rng = np.random.default_rng(5)
    f = np.float32
    x = rng.normal(0, 1, (N, C)).astype(f)
    g = rng.normal(0, 1, (N, O)).astype(f)
    lnw, lnb = _ln(rng, C)
    w1 = (rng.normal(size=(C, Hd)) * C ** -0.5).astype(f)          # (in, out)
    b1 = (rng.normal(size=(Hd,)) * 0.1).astype(f)
    w2 = (rng.normal(size=(Hd, O)) * Hd ** -0.5).astype(f)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(f)
    jd = JD[dtype]
    j = lambda a: jnp.asarray(a).astype(jd)
    fn = lambda *a: JM.fused_two_matmul_vjp(*a, 1e-6, act, ln, res)
    jargs = (j(x), j(lnw)[None], j(lnb)[None], j(w1), j(b1)[None], j(w2),
             j(b2)[None])
    ref, vjp = jax.vjp(fn, *jargs)
    jg = vjp(j(g))
    targs = [_t(x, dtype), _t(lnw, dtype) if ln else None,
             _t(lnb, dtype) if ln else None, _t(w1.T, dtype), _t(b1, dtype),
             _t(w2.T, dtype), _t(b2, dtype)]
    before = (TM.fused_two_matmul.launches, TM.two_matmul_bwd.launches)
    out = TM.two_matmul(*targs, act=act, residual=res)
    out.backward(_t(g, dtype, grad=False))
    assert (TM.fused_two_matmul.launches,
            TM.two_matmul_bwd.launches) == before
    names = ["out", "dx", "dlnw", "dlnb", "dw1", "db1", "dw2", "db2"]
    got = [out, targs[0].grad,
           *(t.grad if t is not None else None for t in targs[1:3]),
           targs[3].grad.T, targs[4].grad, targs[5].grad.T, targs[6].grad]
    want = [ref, jg[0], jg[1][0], jg[2][0], jg[3], jg[4][0], jg[5], jg[6][0]]
    errs = {n: _rel(a, b) for n, a, b in zip(names, got, want)
            if a is not None}
    assert len(errs) == (8 if ln else 6)
    assert max(errs.values()) <= TOL[dtype], errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,K", [(128, 384), (32, 1536)])
def test_ln_linear_grads_match_jax_vjp(dtype, N, K):
    rng = np.random.default_rng(6)
    f = np.float32
    x = rng.normal(0, 1, (N, K)).astype(f)
    g = rng.normal(0, 1, (N, K // 2)).astype(f)
    lnw, lnb = _ln(rng, K)
    w = (rng.normal(size=(K, K // 2)) * K ** -0.5).astype(f)       # (in, out)
    jd = JD[dtype]
    j = lambda a: jnp.asarray(a).astype(jd)
    ref, vjp = jax.vjp(lambda *a: JM.fused_ln_linear(*a, 1e-6), j(x),
                       j(lnw)[None], j(lnb)[None], j(w))
    jg = vjp(j(g))
    targs = [_t(x, dtype), _t(lnw, dtype), _t(lnb, dtype), _t(w.T, dtype)]
    before = (TM.fused_ln_linear.launches, TM.ln_linear_bwd.launches)
    out = TM.ln_linear(*targs)
    out.backward(_t(g, dtype, grad=False))
    assert (TM.fused_ln_linear.launches, TM.ln_linear_bwd.launches) == before
    errs = {n: _rel(a, b) for n, a, b in zip(
        ["out", "dx", "dlnw", "dlnb", "dw"],
        [out, targs[0].grad, targs[1].grad, targs[2].grad, targs[3].grad.T],
        [ref, jg[0], jg[1][0], jg[2][0], jg[3]])}
    assert max(errs.values()) <= TOL[dtype], errs


@pytest.mark.parametrize("act,ln,res,b2", [("gelu", True, True, True),
                                           ("leaky", False, False, False),
                                           ("leaky", True, False, True)])
def test_two_matmul_plain_backward_equals_autograd_float64(act, ln, res, b2):
    """two_matmul_bwd_ref (written out) against autograd of
    fused_two_matmul_ref in float64, where its rounding points are the
    identity: 1e-10 of max|ref| (summation order only)."""
    rng = np.random.default_rng(8)
    N, C, Hd = 48, 64, 160
    O = C if res else 16
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s)).requires_grad_()
    args = [t(N, C), t(C) if ln else None, t(C) if ln else None, t(Hd, C),
            t(Hd), t(O, Hd), t(O) if b2 else None]
    g = torch.from_numpy(rng.normal(0, 1, (N, O)))
    TM.fused_two_matmul_ref(*args, act=act, residual=res).backward(g)
    got = TM.two_matmul_bwd_ref(*(None if a is None else a.detach()
                                  for a in args), g, act=act, residual=res)
    for a, dg in zip(args, got):
        assert (a is None) == (dg is None)
        if a is not None:
            assert dg.dtype == torch.float64
            assert (dg - a.grad).abs().max() <= 1e-10 * a.grad.abs().max()


def test_ln_linear_plain_backward_equals_autograd_float64():
    rng = np.random.default_rng(9)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s)).requires_grad_()
    args = [t(40, 128), t(128), t(128), t(64, 128)]
    g = torch.from_numpy(rng.normal(0, 1, (40, 64)))
    TM.fused_ln_linear_ref(*args).backward(g)
    got = TM.ln_linear_bwd_ref(*(a.detach() for a in args), g)
    for a, dg in zip(args, got):
        assert (dg - a.grad).abs().max() <= 1e-10 * a.grad.abs().max()


def test_backward_wrappers_refuse_other_devices():
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TM.two_matmul_bwd(m(16, 96), m(96), m(96), m(384, 96), m(384),
                          m(96, 384), m(96), m(16, 96), act="gelu",
                          residual=True)
    with pytest.raises(ValueError, match="cuda"):
        TM.ln_linear_bwd(m(16, 384), m(384), m(384), m(192, 384),
                         m(16, 192))


# ---------------------------------------------------------------------------
# The launch plans of the bf16 tensor-core kernels (plain Python, no card):
# what the wrappers pass to the C entry points of csrc/mlp.cu, mlp_bwd.cu
# and reduce.cu.
# ---------------------------------------------------------------------------

def _mlp_shapes():
    """(model, batch, N, C, Hd, O) of every MLP and head launch of
    tulip_base (4 stages) and tulip_large (5) at 32 x 2048, patch 1 x 4,
    batch 1, 2, 4, 8, plus two ragged token counts."""
    out = []
    for model, stages in (("base", 4), ("large", 5)):
        for batch in (1, 2, 4, 8):
            for i in range(stages):
                C = 96 * 2 ** i
                out.append((model, batch, batch * (32 >> i) * (512 >> i), C,
                            4 * C, C))
            out.append((model, batch, batch * 32 * 512, 96, 1536, 16))
    out += [("ragged", 0, 1000, 96, 384, 96), ("ragged", 0, 77, 768, 3072,
                                               768)]
    return out


@pytest.mark.parametrize("model,batch,N,C,Hd,O", _mlp_shapes())
def test_two_matmul_plan_fits_and_covers(model, batch, N, C, Hd, O):
    p = TM.two_matmul_plan(N, C, Hd, O)
    assert p["rows"] == 64 and p["stages"] >= 3
    assert p["smem"] <= TM.SMEM_TWO_PER_SM < TM.SMEM_MAX == 232448
    assert p["splits"] >= 1 and p["hs"] % 128 == 0 and p["hs"] > 0
    # the splits cover the hidden dimension exactly once, none is empty
    assert p["splits"] == -(-Hd // p["hs"])
    assert (p["splits"] - 1) * p["hs"] < Hd <= p["splits"] * p["hs"]
    assert p["resident"] == (C <= 256)
    assert p["bn2"] in (16, 96, 128) and (O > 16 or p["bn2"] == 16)
    # shared memory: alignment room + 3 ring stages + the a slice (+ y)
    stage = 128 * 128 + (0 if p["resident"] else 8192)
    y = -(-C // 64) * 8192 if p["resident"] else 0
    assert p["smem"] == 1024 + 3 * stage + p["hs"] * 128 + y
    # the slice is as long as two blocks per SM allow, or the hidden
    # dimension is split further for the SMs' sake
    assert (p["smem"] + 128 * 128 > TM.SMEM_TWO_PER_SM or p["splits"] == 1
            or -(-N // 64) * (p["splits"] - 1) < TM.NUM_SMS)
    # few row tiles: the hidden dimension is split towards one CTA per SM
    row_tiles = -(-N // 64)
    if row_tiles * 2 <= TM.NUM_SMS and Hd > 128:
        assert p["splits"] > 1
    # dy: every 64-deep tile of Hd in exactly one split
    s = TM.dy_splits(N, C, Hd)
    kt = -(-Hd // 64)
    assert 1 <= s <= kt and -(-kt // -(-kt // s)) == s


def test_two_matmul_plan_streams_rows_too_wide_to_keep():
    """A row tile that shared memory cannot hold (64 x 8192 bf16 = 1 MB) is
    streamed, so the plan still fits."""
    p = TM.two_matmul_plan(64, 8192, 4 * 8192, 8192)
    assert not p["resident"] and p["smem"] <= TM.SMEM_TWO_PER_SM
    assert p["splits"] * p["hs"] >= 4 * 8192


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,M,N", [(131072, 384, 96), (131072, 16, 1536),
                                   (2048, 3072, 768), (1000, 384, 96),
                                   (77, 96, 384), (256, 1536, 3072)])
def test_tn_gemm_plan_covers_tokens_once(dtype, T, M, N):
    from tulip_tpu_torch.ops.reduce import tn_gemm_plan
    splits, tps = tn_gemm_plan(T, M, N, dtype)
    assert splits >= 1
    assert tps % (64 if dtype == torch.bfloat16 else 32) == 0
    # split s owns tokens [s tps, min(T, (s + 1) tps)): all of them, once
    assert (splits - 1) * tps < T <= splits * tps


@pytest.mark.parametrize("case", ["mlp", "head", "ragged"])
def test_split_hidden_partial_sums_equal_plain_float64(case):
    """What the split launches compute: each split's slice of the hidden
    dimension gives a partial out (forward) and a partial dy (backward),
    added in split order; in float64 that equals the plain versions to
    summation order (1e-12 of max|ref|)."""
    N, C, Hd, O, act, ln, res = {
        "mlp": (96, 64, 512, 64, "gelu", True, True),
        "head": (64, 96, 1536, 16, "leaky", True, False),
        "ragged": (50, 32, 160, 32, "gelu", False, True)}[case]
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s))
    x, g = t(N, C), t(N, O)
    lnw, lnb = (t(C), t(C)) if ln else (None, None)
    w1, b1, w2, b2 = t(Hd, C) * C ** -0.5, t(Hd), t(O, Hd) * Hd ** -0.5, t(O)
    hs = 128
    splits = -(-Hd // hs)
    y = x if lnw is None else TM.layer_norm(x, lnw, lnb, 1e-6)
    out = torch.zeros(N, O, dtype=torch.float64)
    dy = torch.zeros(N, C, dtype=torch.float64)
    for s in range(splits):
        sl = slice(s * hs, min(Hd, (s + 1) * hs))
        h = y @ w1[sl].T + b1[sl]
        a = TM.gelu(h) if act == "gelu" else TM.leaky_relu(h)
        out += a @ w2[:, sl].T
        dy += (g @ w2[:, sl] * TM._act_grad(h, act)) @ w1[sl]
    out = out + b2 + (x if res else 0)
    ref = TM.fused_two_matmul_ref(x, lnw, lnb, w1, b1, w2, b2, act=act,
                                  residual=res)
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()
    ref_dx = TM.two_matmul_bwd_ref(x, lnw, lnb, w1, b1, w2, b2, g, act=act,
                                   residual=res)[0]
    if lnw is None:
        dx = dy
    else:
        xh, rstd = TM._ln_stats(x, 1e-6)
        dx = TM._ln_backward(dy, xh, rstd, lnw)[0]
    dx = dx + (g if res else 0)
    assert (dx - ref_dx).abs().max() <= 1e-12 * ref_dx.abs().max()


@pytest.mark.parametrize("C,Hd", [(48, 128), (64, 80)])
def test_wrappers_refuse_widths_not_multiples_of_32(C, Hd):
    """On any device but the CPU the wrappers check the device first and
    then the widths; the width check is reached with a CUDA tensor only, so
    here its rule is held through the plan and the meta device."""
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TM.fused_two_matmul(m(16, C), None, None, m(Hd, C), m(Hd), m(C, Hd),
                            None, act="gelu", residual=True)
    with pytest.raises(ValueError, match="cuda"):
        TM.two_matmul_bwd(m(16, C), None, None, m(Hd, C), m(Hd), m(C, Hd),
                          None, m(16, C), act="gelu", residual=True)
    assert TM.check_widths(96, 384, 96, True, "two_matmul") is None
    with pytest.raises(NotImplementedError, match="multiples of 32"):
        TM.check_widths(C, Hd, C, True, "two_matmul")
    with pytest.raises(NotImplementedError, match="O == C"):
        TM.check_widths(96, 384, 16, True, "two_matmul")


def test_require_aligned_refuses_an_offset_view():
    """The tensor-core kernels copy 16 bytes at a time: a view that starts
    2 bytes into its storage is refused before its pointer reaches C."""
    from tulip_tpu_torch.ops import build
    t = torch.zeros(64, dtype=torch.bfloat16)
    build.require_aligned("t", t)
    build.require_aligned("none", None)
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned("t", t[1:])


# ---------------------------------------------------------------------------
# The launch plan of the bf16 tensor-core LN + matmul (K4) and the dy splits
# its backward (K11) takes over from K10.
# ---------------------------------------------------------------------------

def _merge_shapes():
    """(model, batch, N, K, O) of every patch merging of tulip_base (3) and
    tulip_large (4) at 32 x 2048, patch 1 x 4, batch 1, 2, 4, 8, plus a
    ragged token count."""
    out = []
    for model, stages in (("base", 4), ("large", 5)):
        for batch in (1, 2, 4, 8):
            for i in range(1, stages):
                K = 4 * 96 * 2 ** (i - 1)
                out.append((model, batch, batch * (32 >> i) * (512 >> i), K,
                            K // 2))
    return out + [("ragged", 0, 1000, 384, 192)]


@pytest.mark.parametrize("model,batch,N,K,O", _merge_shapes())
def test_ln_linear_plan_fits_and_covers(model, batch, N, K, O):
    p = TM.ln_linear_plan(N, K, O)
    rows, cols, splits = p["grid"]
    assert p["rows"] == 64 and p["bn"] == (192 if O % 192 == 0 else 128)
    # every row, column and 64-deep slab of K in exactly one CTA
    assert (rows - 1) * 64 < N <= rows * 64
    assert (cols - 1) * p["bn"] < O <= cols * p["bn"]
    kt = -(-K // 64)
    assert splits == p["splits"] >= 1 and p["kts"] >= 1
    assert (splits - 1) * p["kts"] < kt <= splits * p["kts"]
    # shared memory: alignment room + three stages of W (bn x 64) and y
    # (64 x 64) in bf16; two CTAs fit an SM
    assert p["smem"] == 1024 + 3 * (p["bn"] * 128 + 8192)
    assert p["smem"] <= TM.SMEM_TWO_PER_SM < TM.SMEM_MAX == 232448
    # the fp32 partial sums of a split launch stay under the cap
    assert splits == 1 or splits * N * O * 4 <= TM.PARTIAL_CAP == 32 << 20
    # K is split only where the tiles alone leave SMs idle, towards one CTA
    # per SM (two where a split keeps six slabs)
    if rows * cols > TM.NUM_SMS:
        assert splits == 1
    else:
        assert rows * cols * splits <= 2 * TM.NUM_SMS
        assert splits > 1 or kt < 4 or rows * cols * 2 > TM.NUM_SMS
    # K11: dy = g W splits O; every 64-deep tile of O in exactly one split
    s = TM.dy_splits(N, K, O)
    ko = -(-O // 64)
    assert 1 <= s <= ko and -(-ko // -(-ko // s)) == s
    assert s == 1 or -(-N // 64) * -(-K // 192) * s <= TM.NUM_SMS


def test_ln_linear_plan_splits_the_batch_1_merges():
    """The plans the batch-1 forward of tulip_base runs: (row tiles, column
    tiles, splits of K), about one CTA per SM each."""
    assert [TM.ln_linear_plan(N, K, K // 2)["grid"] for N, K in
            ((4096, 384), (1024, 768), (256, 1536))] == [
                (64, 1, 2), (16, 2, 4), (4, 4, 8)]
    assert TM.ln_linear_plan(32768, 384, 192)["grid"] == (512, 1, 1)
    # a chain of 24 slabs alone on its SM is halved for a second CTA
    assert TM.ln_linear_plan(2048, 1536, 768)["grid"] == (32, 4, 2)
    # O no multiple of 192: 128-column tiles, the last one ragged
    p = TM.ln_linear_plan(64, 512, 200)
    assert p["bn"] == 128 and p["grid"][1] == 2


@pytest.mark.parametrize("N,K,O", [(256, 1536, 768), (100, 384, 192),
                                   (64, 3072, 1536), (50, 96, 40)])
def test_split_k_partial_sums_equal_plain_float64(N, K, O):
    """What the split launch of K4 computes: each split's 64-deep slabs of
    K give a partial out, added in split order; in float64 that equals the
    plain version to summation order (1e-12 of max|ref|).  K11's dy = g W,
    split over O by dy_splits, likewise equals the plain backward's dx."""
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s))
    x, lnw, lnb, w, g = t(N, K), t(K), t(K), t(O, K) * K ** -0.5, t(N, O)
    p = TM.ln_linear_plan(N, K, O)
    y = TM.layer_norm(x, lnw, lnb, 1e-6)
    out = torch.zeros(N, O, dtype=torch.float64)
    for s in range(p["splits"]):
        sl = slice(s * p["kts"] * 64, min(K, (s + 1) * p["kts"] * 64))
        assert sl.start < K
        out += y[:, sl] @ w[:, sl].T
    ref = TM.fused_ln_linear_ref(x, lnw, lnb, w)
    assert (out - ref).abs().max() <= 1e-12 * ref.abs().max()
    splits = TM.dy_splits(N, K, O)
    ko = -(-O // 64)
    per = -(-ko // splits) * 64
    dy = torch.zeros(N, K, dtype=torch.float64)
    for s in range(splits):
        sl = slice(s * per, min(O, (s + 1) * per))
        assert sl.start < O
        dy += g[:, sl] @ w[sl]
    xh, rstd = TM._ln_stats(x, 1e-6)
    dx = TM._ln_backward(dy, xh, rstd, lnw)[0]
    ref_dx = TM.ln_linear_bwd_ref(x, lnw, lnb, w, g)[0]
    assert (dx - ref_dx).abs().max() <= 1e-12 * ref_dx.abs().max()


@pytest.mark.parametrize("what", ["ln_linear kernel", "ln_linear backward"])
def test_ln_linear_refuses_what_the_kernels_do_not_take(what):
    """The checks both K4 / K11 wrappers make on a CUDA tensor before any
    pointer reaches C, held here through the function they call."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert TM.check_ln_linear(384, 192, bf16, what) is None
    assert TM.check_ln_linear(384, 100, f32, what) is None
    with pytest.raises(NotImplementedError, match="K % 32"):
        TM.check_ln_linear(400, 200, bf16, what)
    with pytest.raises(NotImplementedError, match="K % 32"):
        TM.check_ln_linear(48, 24, f32, what)
    with pytest.raises(NotImplementedError, match="O % 8"):
        TM.check_ln_linear(384, 100, bf16, what)
    x = torch.zeros(4 * 384 + 8, dtype=bf16)
    ok = (("x", x[:4 * 384].view(4, 384)),
          ("lnw", torch.zeros(384, dtype=bf16)))
    assert TM.check_ln_linear(384, 192, bf16, what, ok) is None
    off = (("x", x[1:4 * 384 + 1].view(4, 384)),)
    with pytest.raises(ValueError, match="x must start on a 16-byte"):
        TM.check_ln_linear(384, 192, bf16, what, off)
    # fp32 reads element by element: an offset view is taken
    assert TM.check_ln_linear(384, 192, f32, what,
                              (("x", torch.zeros(9)[1:]),)) is None


def test_forward_wrappers_refuse_other_devices():
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TM.fused_ln_linear(m(16, 384), m(384), m(384), m(192, 384))
    with pytest.raises(ValueError, match="cuda"):
        TM.ln_linear(m(16, 384), m(384), m(384), m(192, 384))
