"""The port's training attention core (tulip_tpu_torch.ops.attn_core)
against the JAX package on the CPU.

- The attention half of a training block, qkv linear -> AttnCore -> proj
  linear, against tulip_tpu.models.swin.window_attention_pallas_train,
  whose core is the Pallas custom VJP of attn_core.py (_fwd_kernel K8,
  _bwd_kernel K9) in interpret mode: the output and the VJP with respect to
  the input, qkv.weight / bias, proj.weight / bias and the relative-position
  bias table.  The bias layouts differ (grouped (GL, nh GL) in JAX,
  (nh, 16, 16) here); the table's gradient does not depend on the layout,
  so that is where they are compared.  Limits relative to each tensor's
  max|ref|: fp32 1e-4 (summation order), bf16 2e-2 (JAX rounds q * scale
  to bf16 before QK^T, the port scales the fp32 logits; bf16 linears).
- The written-out plain backward against torch.autograd of the plain
  forward in float64, to 1e-10 (the same math in another order).
- The launch plan of the bf16 kernels (attn_core_plan) at every stage of
  TULIP-base and TULIP-large at batch 1 and 8, on a grid whose window count
  the tile does not divide, and at every head count up to 48: the grid's
  walk (as csrc/attn_core.cu's kernels take it) covers every (window, head)
  once, the head groups cover every head once, shared memory fits a block
  and the d(bias) partials are the rows colsum adds.
"""

from collections import Counter

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import StageConfig
from tulip_tpu.models import swin as JS
from tulip_tpu_torch.config import model_config
from tulip_tpu_torch.models import layers as L
from tulip_tpu_torch.ops import attn_core as TA

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRID, WINDOW, SHIFT = (4, 128), (2, 8), (1, 4)


def _rel(out, ref):
    out = out.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return np.abs(out - ref).max() / np.abs(ref).max()


def _inputs(C, nh, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    y = rng.normal(0, 1, (1, *GRID, C)).astype(f)
    g = rng.normal(0, 1, (1, *GRID, C)).astype(f)
    p = {"attn.qkv.weight": (rng.normal(size=(C, 3 * C)) * C ** -0.5),
         "attn.qkv.bias": rng.normal(size=(3 * C,)) * 0.1,
         "attn.proj.weight": rng.normal(size=(C, C)) * C ** -0.5,
         "attn.proj.bias": rng.normal(size=(C,)) * 0.1,
         "attn.relative_position_bias_table":
             rng.normal(size=(45, nh)) * 0.5}
    return y, g, {k: v.astype(f) for k, v in p.items()}


def _port_attention(y, w, nh, shifted):
    """qkv linear -> AttnCore -> proj linear, as SwinBlockV1's training
    branch runs it (w: torch-layout parameters)."""
    idx = torch.as_tensor(L.relative_position_index(WINDOW)).reshape(-1)
    bias = w["table"].float()[idx].reshape(16, 16, nh).permute(2, 0, 1)
    mask = (torch.as_tensor(L.shift_attention_mask(GRID, WINDOW, SHIFT))
            if shifted else None)
    qkv = L.linear(y, w["qkv.weight"], w["qkv.bias"])
    o = TA.attn_core(qkv, bias.contiguous(), mask, window=WINDOW,
                     shift=SHIFT if shifted else (0, 0))
    return L.linear(o, w["proj.weight"], w["proj.bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("C,nh", [(96, 3), (384, 12)])
def test_attention_half_matches_jax_pallas_vjp(C, nh, shifted, dtype):
    y, g, p = _inputs(C, nh, seed=C + shifted)
    stage = StageConfig(dim=C, depth=2, num_heads=nh, grid=GRID,
                        window=WINDOW, shift=SHIFT, drop_path=(0.0, 0.0))
    st = JS.make_block_static(stage, int(shifted), WINDOW)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref, vjp = jax.vjp(
        lambda yy, pp: JS.window_attention_pallas_train(pp, "attn", yy, st),
        jnp.asarray(y).astype(jd), jp)
    ref_dy, ref_dp = vjp(jnp.asarray(g).astype(jd))

    td = getattr(torch, dtype)
    yt = torch.from_numpy(y).to(td).requires_grad_()
    w = {"qkv.weight": p["attn.qkv.weight"].T, "qkv.bias": p["attn.qkv.bias"],
         "proj.weight": p["attn.proj.weight"].T,
         "proj.bias": p["attn.proj.bias"],
         "table": p["attn.relative_position_bias_table"]}
    w = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
         for k, v in w.items()}
    before = (TA.attn_core_fwd.launches, TA.attn_core_bwd.launches)
    out = _port_attention(yt, w, nh, shifted)
    out.backward(torch.from_numpy(g).to(td))
    # the CPU path takes the plain versions and launches nothing
    assert (TA.attn_core_fwd.launches, TA.attn_core_bwd.launches) == before
    assert out.dtype == td and yt.grad.dtype == td
    pairs = [("out", out, ref), ("dx", yt.grad, ref_dy),
             ("qkv.weight", w["qkv.weight"].grad.T,
              ref_dp["attn.qkv.weight"]),
             ("qkv.bias", w["qkv.bias"].grad, ref_dp["attn.qkv.bias"]),
             ("proj.weight", w["proj.weight"].grad.T,
              ref_dp["attn.proj.weight"]),
             ("proj.bias", w["proj.bias"].grad, ref_dp["attn.proj.bias"]),
             ("table", w["table"].grad,
              ref_dp["attn.relative_position_bias_table"])]
    errs = {name: _rel(a, b) for name, a, b in pairs}
    assert max(errs.values()) <= TOL[dtype], errs


@pytest.mark.parametrize("shift", [(0, 0), (1, 4)])
def test_plain_backward_equals_autograd_float64(shift):
    """attn_core_bwd_ref (written out, P recomputed) against autograd of
    attn_core_ref in float64, where its rounding points are the identity:
    1e-10 of max|ref| (summation order only)."""
    rng = np.random.default_rng(7)
    B, H, W, nh, hd = 2, 4, 16, 2, 32
    C = nh * hd
    qkv = torch.from_numpy(rng.normal(0, 1, (B, H, W, 3 * C))
                           ).requires_grad_()
    bias = torch.from_numpy(rng.normal(0, 0.5, (nh, 16, 16))).requires_grad_()
    mask = (torch.from_numpy(L.shift_attention_mask((H, W), WINDOW, shift)
                             .astype(np.float64)) if any(shift) else None)
    dout = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)))
    kw = dict(window=WINDOW, shift=shift)
    TA.attn_core_ref(qkv, bias, mask, **kw).backward(dout)
    dqkv, dbias = TA.attn_core_bwd_ref(qkv.detach(), bias.detach(), mask,
                                       dout, **kw)
    for got, ref in ((dqkv, qkv.grad), (dbias, bias.grad)):
        assert got.dtype == torch.float64
        assert (got - ref).abs().max() <= 1e-10 * ref.abs().max()


def test_plain_forward_equals_window_msa_core():
    """With identity LN and projections the attention core is the window
    MSA of the inference kernel's plain version minus its residual."""
    from tulip_tpu_torch.ops.window_msa import window_msa_ref
    rng = np.random.default_rng(3)
    B, H, W, nh = 1, 4, 32, 2
    C = 32 * nh
    x = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32))
    eye = torch.eye(C)
    wqkv = torch.cat([eye, eye * 0.5, eye * 2.0])
    bias = torch.from_numpy(rng.normal(0, 0.5, (nh, 16, 16)).astype(np.float32))
    mask = torch.as_tensor(L.shift_attention_mask((H, W), WINDOW, SHIFT))
    zeros = torch.zeros(C)
    y = L.layer_norm(x, torch.ones(C), zeros, 1e-6)
    ref = window_msa_ref(x, torch.ones(C), zeros, wqkv, torch.zeros(3 * C),
                         eye, zeros, bias, mask, window=WINDOW, shift=SHIFT,
                         eps=1e-6) - x
    out = TA.attn_core_ref(L.linear(y, wqkv), bias, mask, window=WINDOW,
                           shift=SHIFT)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_other_devices():
    """A tensor on neither cpu nor cuda raises in the forward and in the
    backward instead of taking a path."""
    m = lambda *s: torch.empty(*s, device="meta")
    kw = dict(window=WINDOW, shift=(0, 0))
    with pytest.raises(ValueError, match="cuda"):
        TA.attn_core_fwd(m(1, 2, 8, 288), m(3, 16, 16), None, **kw)
    with pytest.raises(ValueError, match="cuda"):
        TA.attn_core_bwd(m(1, 2, 8, 288), m(3, 16, 16), None,
                         m(1, 2, 8, 96), **kw)


SMEM_MAX = 232448   # shared bytes one block can use on sm_90


def _check_plan(T, C, nh, backward):
    """Walk the plan's grid as the kernels do: CTA (x, y) takes head group y
    (heads y hg .. y hg + hg - 1) and tiles x, x + ctas, ... of four windows;
    the backward CTA writes its heads' row x of the d(bias) partials."""
    plan = TA.attn_core_plan(T, C, nh, backward)
    hg, ctas = plan["hg"], plan["ctas"]
    assert plan["windows"] == T // 16 and plan["groups"] * hg == nh
    assert 1 <= ctas <= plan["tiles"] and plan["groups"] <= 65535
    assert plan["threads"] == 128 * hg <= 384
    parts = 4 if backward else 3
    assert plan["smem"] == 2 * 64 * (64 * hg * parts + 16) <= SMEM_MAX
    pairs, rows, heads = Counter(), Counter(), Counter()
    for y in range(plan["groups"]):
        group = range(y * hg, (y + 1) * hg)
        heads.update(group)
        for x in range(ctas):
            rows.update((x, h) for h in group)
            for tile in range(x, plan["tiles"], ctas):
                for w in range(4 * tile, min(4 * tile + 4, plan["windows"])):
                    pairs.update((w, h) for h in group)
    assert heads == Counter(range(nh))
    assert pairs == Counter((w, h) for w in range(plan["windows"])
                            for h in range(nh))
    # colsum adds the (ctas, nh * 256) partials over their rows into the
    # (nh, 16, 16) gradient: every (row, head) written once
    assert plan["part"] == (ctas, nh * 256)
    assert rows == Counter((x, h) for x in range(ctas) for h in range(nh))
    return plan


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", ["tulip_base", "tulip_large"])
def test_attn_core_plan_covers_every_stage(model, batch, backward):
    """Every stage a training step of TULIP-base / TULIP-large at DurLAR
    32x2048 -> 128x2048 runs: every window and head once, two CTAs per SM
    where the tiles are enough to fill the card."""
    cfg = model_config(model, (32, 2048), (128, 2048))
    stages = cfg.encoder_stages + cfg.decoder_stages
    assert {s.num_heads for s in stages} >= {3, 24}
    for st in stages:
        T = batch * st.grid[0] * st.grid[1]
        plan = _check_plan(T, st.dim, st.num_heads, backward)
        assert plan["ctas"] * plan["groups"] >= min(
            264, plan["tiles"] * plan["groups"])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch,C,nh", [(1, 96, 3), (3, 768, 24)])
def test_attn_core_plan_ragged_tile(batch, C, nh, backward):
    """A 2 x 40 grid holds 5 windows of 2 x 8 an image: the last tile of
    four windows is short."""
    plan = _check_plan(batch * 2 * 40, C, nh, backward)
    assert plan["windows"] % 4 != 0


@pytest.mark.parametrize("nh", range(1, 49))
def test_attn_core_plan_head_counts(nh):
    """Every head count a model may be given (num_heads overrides): the
    largest group of at most 3 heads that divides it."""
    for backward in (False, True):
        plan = _check_plan(8 * 4 * 64, 32 * nh, nh, backward)
        assert plan["hg"] == max(d for d in (1, 2, 3) if nh % d == 0)
