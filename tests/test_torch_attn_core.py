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
- The launch plan of the bf16 and the fp32 kernels (attn_core_plan) at
  every stage of TULIP-base and TULIP-large at batch 1 and 8, on a grid
  whose window count the tile does not divide, and at every head count up
  to 48: the grid's walk (as csrc/attn_core.cu's kernels take it) covers
  every (window, head) once, the head groups cover every head once, shared
  memory fits a block, the blocks an SM it counts on fit the SM's shared
  memory and registers, and the d(bias) partials are the rows colsum adds.
- The fp32 kernels' split-TF32 window products, emulated in numpy in
  their fragment and token order, forward and backward with d(bias),
  against float64: within 1e-5 of max|ref|, where one TF32 product is not.
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
from test_torch_fp32_plans import _split

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
SM_SMEM = 233472    # shared bytes of an SM; 1 KB kept per block
# windows a tile and (threads, blocks an SM) of the kernels'
# __launch_bounds__, by (element size, backward): bf16 four windows, (384,
# 2); fp32 two windows of three heads, (192, blocks that shared memory
# holds)
TILE_WINDOWS = {2: 4, 4: 2}
LAUNCH_BOUNDS = {(2, False): (384, 2), (2, True): (384, 2),
                 (4, False): (192, 3), (4, True): (192, 2)}


def _check_plan(T, C, nh, backward, esz=2):
    """Walk the plan's grid as the kernels do: CTA (x, y) takes head group y
    (heads y hg .. y hg + hg - 1) and tiles x, x + ctas, ... of win windows;
    the backward CTA writes its heads' row x of the d(bias) partials.  The
    blocks an SM it counts on fit the SM's shared memory and, at the
    registers a thread the launch bounds allow, its 65,536 registers."""
    plan = TA.attn_core_plan(T, C, nh, backward, esz=esz)
    hg, ctas = plan["hg"], plan["ctas"]
    assert plan["windows"] == T // 16 and plan["groups"] * hg == nh
    assert 1 <= ctas <= plan["tiles"] and plan["groups"] <= 65535
    win = plan["tile_windows"]
    assert win == TILE_WINDOWS[esz]
    assert plan["tiles"] == -(-plan["windows"] // win)
    bound_threads, bound_blocks = LAUNCH_BOUNDS[esz, backward]
    assert plan["threads"] == 32 * win * hg <= bound_threads
    parts = 4 if backward else 3
    assert plan["smem"] == 2 * 16 * win * (32 * esz * hg * parts
                                           + 16) <= SMEM_MAX
    regs = min(255, 65536 // (bound_threads * bound_blocks))
    assert plan["per_sm"] * (plan["smem"] + 1024) <= SM_SMEM
    assert plan["per_sm"] * plan["threads"] * regs <= 65536
    # every CTA resident at once: no second wave
    assert plan["ctas"] * plan["groups"] <= max(plan["groups"],
                                                plan["per_sm"] * 132)
    pairs, rows, heads = Counter(), Counter(), Counter()
    for y in range(plan["groups"]):
        group = range(y * hg, (y + 1) * hg)
        heads.update(group)
        for x in range(ctas):
            rows.update((x, h) for h in group)
            for tile in range(x, plan["tiles"], ctas):
                for w in range(win * tile,
                               min(win * tile + win, plan["windows"])):
                    pairs.update((w, h) for h in group)
    assert heads == Counter(range(nh))
    assert pairs == Counter((w, h) for w in range(plan["windows"])
                            for h in range(nh))
    # colsum adds the (ctas, nh * 256) partials over their rows into the
    # (nh, 16, 16) gradient: every (row, head) written once
    assert plan["part"] == (ctas, nh * 256)
    assert rows == Counter((x, h) for x in range(ctas) for h in range(nh))
    return plan


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", ["tulip_base", "tulip_large"])
def test_attn_core_plan_covers_every_stage(model, batch, backward, esz):
    """Every stage a training step of TULIP-base / TULIP-large at DurLAR
    32x2048 -> 128x2048 runs, bf16 (esz 2) and fp32 (esz 4): every window
    and head once, groups of three heads, the blocks an SM holds (bf16 two,
    fp32 three forward and two backward) on every SM, but for fewer than
    a group's CTAs, where the tiles are enough to fill the card."""
    cfg = model_config(model, (32, 2048), (128, 2048))
    stages = cfg.encoder_stages + cfg.decoder_stages
    assert {s.num_heads for s in stages} >= {3, 24}
    for st in stages:
        T = batch * st.grid[0] * st.grid[1]
        plan = _check_plan(T, st.dim, st.num_heads, backward, esz)
        assert plan["hg"] == 3
        assert plan["per_sm"] == {2: 2, 4: 2 if backward else 3}[esz]
        assert plan["ctas"] * plan["groups"] > min(
            plan["per_sm"] * 132 - plan["groups"],
            plan["tiles"] * plan["groups"] - 1)


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch,C,nh", [(1, 96, 3), (3, 768, 24)])
def test_attn_core_plan_ragged_tile(batch, C, nh, backward, esz):
    """A 2 x 40 grid holds 5 windows of 2 x 8 an image: the last tile of
    four windows is short."""
    plan = _check_plan(batch * 2 * 40, C, nh, backward, esz)
    assert plan["windows"] % 4 != 0


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("nh", range(1, 49))
def test_attn_core_plan_head_counts(nh, esz):
    """Every head count a model may be given (num_heads overrides): the
    largest group of at most 3 heads that divides it."""
    for backward in (False, True):
        plan = _check_plan(8 * 4 * 64, 32 * nh, nh, backward, esz)
        assert plan["hg"] == max(d for d in (1, 2, 3) if nh % d == 0)


# ---------------------------------------------------------------------------
# fp32 K8 / K9: the split-TF32 window products of attn_fwd_tf32_kernel /
# attn_bwd_tf32_kernel, emulated in numpy
# ---------------------------------------------------------------------------

# the key (or query) order of a product over tokens: in tile kt, k index q
# is token 8 kt + 2 q and q + 4 is 8 kt + 2 q + 1 (a D fragment taken as
# the A operand as it is)
_TOKEN_ORDER = np.array([8 * kt + 2 * q + e for kt in range(2)
                         for e in range(2) for q in range(4)])


def _mma(d, a, b):
    """One mma.sync m16n8k8 (or a row of them): d + a b with the TF32
    products exact and their sum rounded to fp32 once."""
    return (d.astype(np.float64) + a.astype(np.float64)
            @ b.astype(np.float64)).astype(np.float32)


def _product(a, b, split):
    """a (M, K) b (K, N) as the kernels sum it: k-steps of 8 in order, each
    step's split TF32 products lo hi, hi lo, hi hi into the fp32 sum (or
    one TF32 product, hi hi, where not split)."""
    d = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        x, y = a[:, k0:k0 + 8], b[k0:k0 + 8]
        (xh, xl), (yh, yl) = _split(x), _split(y)
        if split:
            d = _mma(_mma(_mma(d, xl, yh), xh, yl), xh, yh)
        else:
            d = _mma(d, xh, yh)
    return d


def _over_tokens(a, b, split):
    """a (M, 16 tokens) b (16 tokens, N) in the kernels' token order."""
    return _product(a[:, _TOKEN_ORDER], b[_TOKEN_ORDER], split)


def _row_sum(t):
    """A row's sum as window_softmax / dsoftmax take it: lane q holds
    columns 2 q, 2 q + 1, 8 + 2 q, 9 + 2 q, adds (c0 + c1) + (c8 + c9),
    then the lanes xor 1 and xor 2."""
    lane = [(t[:, 2 * q] + t[:, 2 * q + 1]) + (t[:, 8 + 2 * q]
                                               + t[:, 9 + 2 * q])
            for q in range(4)]
    pair = [lane[q] + lane[q ^ 1] for q in range(4)]
    return (pair[0] + pair[2])[:, None]


def _window_f32(q, k, v, do, bias, mask, split=True):
    """One window and head as the fp32 kernels compute it: (o, dq, dk, dv,
    dS), fp32 numpy."""
    f = np.float32
    scale = f(32 ** -0.5)
    s = _product(q, k.T, split) * scale + bias + mask
    e = np.exp(s - s.max(1, keepdims=True))
    p = e * (f(1) / _row_sum(e))
    o = _over_tokens(p, v, split)
    dp = _product(do, v.T, split)
    t = p * dp
    ds = t - p * _row_sum(t)
    dq = _over_tokens(ds, k, split) * scale
    dk = _over_tokens(ds.T, q, split) * scale
    dv = _over_tokens(p.T, do, split)
    return o, dq, dk, dv, ds


def _window_f64(q, k, v, do, bias, mask):
    q, k, v, do, bias, mask = (x.astype(np.float64)
                               for x in (q, k, v, do, bias, mask))
    scale = 32 ** -0.5
    s = q @ k.T * scale + bias + mask
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(1, keepdims=True))
    return p @ v, ds @ k * scale, ds.T @ q * scale, p.T @ do, ds


@pytest.mark.parametrize("shifted", [False, True])
def test_f32_window_products_hold_fp32_accuracy(shifted):
    """The fp32 kernels' window products in their own fragment and token
    order (S = q k^T and dP = dO v^T over four k-steps of 8 dims; P v, dS k,
    dS^T q, P^T dO over two 8-token steps in the order 0, 2, 4, 6, 1, 3, 5,
    7), the softmax's row sums as the lanes add them, and d(bias) summed as
    the backward kernel and colsum add it (a warp's windows in its walk's
    order, then the fp32 plan's window slots, then the CTAs): within 1e-5
    of each output's max|float64| on 24 windows, where one TF32 product a
    product misses that."""
    rng = np.random.default_rng(21 + shifted)
    f = np.float32
    wins = 24
    q, k, v, do = (rng.normal(0, 1, (4, wins, 16, 32)).astype(f))
    bias = rng.normal(0, 0.5, (16, 16)).astype(f)
    masks = L.shift_attention_mask((4, 64), WINDOW, SHIFT).astype(f)
    names = ("o", "dq", "dk", "dv")
    worst = {True: dict.fromkeys(names, 0.0), False: {}}
    ds32, ds64 = [], []
    for w in range(wins):
        mask = masks[w % len(masks)] if shifted else np.zeros((16, 16), f)
        args = (q[w], k[w], v[w], do[w], bias, mask)
        ref = _window_f64(*args)
        for split in (True, False):
            got = _window_f32(*args, split=split)
            for name, a, b in zip(names, got, ref):
                err = np.abs(a - b).max() / np.abs(b).max()
                worst[split][name] = max(worst[split].get(name, 0.0), err)
            if split:
                ds32.append(got[4])
        ds64.append(ref[4])
    assert max(worst[True].values()) <= 1e-5, worst[True]
    assert max(worst[False].values()) > 1e-4, worst[False]
    # d(bias): 3 CTAs walk tiles of the fp32 plan's windows (CTA c: tiles
    # c, c + 3, ...); each warp (window slot) sums its windows, the CTA its
    # slots in order, colsum the CTAs in order
    win = TA.attn_core_plan(wins * 16, 32, 1, True, esz=4)["tile_windows"]
    ctas, tiles = 3, wins // win
    rows = []
    for c in range(ctas):
        slots = [np.zeros((16, 16), f) for _ in range(win)]
        for t in range(c, tiles, ctas):
            for slot in range(win):
                slots[slot] = slots[slot] + ds32[win * t + slot]
        row = np.zeros((16, 16), f)
        for slot in slots:
            row = row + slot
        rows.append(row)
    db = np.zeros((16, 16), f)
    for row in rows:
        db = db + row
    ref = np.sum(ds64, axis=0)
    assert np.abs(db - ref).max() <= 1e-5 * np.abs(ref).max()
