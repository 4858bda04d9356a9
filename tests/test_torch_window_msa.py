"""The port's window-MSA half-block (tulip_tpu_torch.ops.window_msa) against
the JAX package's fused half-block, whose Pallas kernels run in interpret
mode on the CPU: window_msa.py:_kernel_masked_nat for heads <= 8 (K1) and
window_msa.py:_kernel for heads > 8 (K2); and the two other layouts' entry
points against theirs: window_msa_grouped against _kernel_masked (K12),
window_msa_nat against _kernel_nat (K13).

Inputs and weights come from one numpy seed and feed both packages.  The
limits are relative to max|ref|: 1e-4 in fp32 (summation order only), 2e-2
in bf16 (the JAX bf16 kernels use a clamped softmax without max
subtraction, equal in exact arithmetic, and round at other points)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tulip_tpu.config import StageConfig
from tulip_tpu.models import swin as S
from tulip_tpu_torch.ops import window_msa as TW

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _case(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    f = np.float32
    p = {
        "b.norm1.weight": rng.normal(1, 0.1, (C,)).astype(f),
        "b.norm1.bias": rng.normal(0, 0.1, (C,)).astype(f),
        "b.attn.qkv.weight": (rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(f),
        "b.attn.qkv.bias": (rng.normal(size=(3 * C,)) * 0.1).astype(f),
        "b.attn.proj.weight": (rng.normal(size=(C, C)) * C ** -0.5).astype(f),
        "b.attn.proj.bias": (rng.normal(size=(C,)) * 0.1).astype(f),
        "b.attn.relative_position_bias_table":
            (rng.normal(size=(45, C // 32)) * 0.5).astype(f),
    }
    x = rng.normal(0, 1, (B, H, W, C)).astype(f)
    return p, x


def _port_args(p, dtype, st):
    t = lambda k: torch.from_numpy(p[f"b.{k}"]).to(dtype)
    idx = torch.as_tensor(st.rel_index).reshape(-1)
    table = torch.from_numpy(p["b.attn.relative_position_bias_table"])
    bias = table[idx].reshape(16, 16, -1).permute(2, 0, 1).contiguous()
    mask = None if st.mask is None else torch.from_numpy(st.mask)
    return [t("norm1.weight"), t("norm1.bias"),
            t("attn.qkv.weight").T.contiguous(), t("attn.qkv.bias"),
            t("attn.proj.weight").T.contiguous(), t("attn.proj.bias"),
            bias, mask]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C,nh,shifted", [
    (1, 4, 64, 96, 3, False),     # K1, stage-0 width
    (1, 4, 64, 96, 3, True),
    (1, 4, 32, 192, 6, False),    # K1, stage-1 width
    (1, 4, 32, 192, 6, True),
    (1, 4, 16, 384, 12, True),    # K2, stage-2 width
    (1, 2, 16, 768, 24, True),    # K2, stage-3 width
])
def test_half_block_matches_jax_pallas(dtype, B, H, W, C, nh, shifted):
    p, x = _case(0, B, H, W, C)
    stage = StageConfig(dim=C, depth=2, num_heads=nh, grid=(H, W),
                        window=(2, 8), shift=(1, 4), drop_path=(0.0, 0.0))
    st = S.make_block_static(stage, int(shifted), (2, 8))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    ref = S.fused_half_block_pallas({k: jnp.asarray(v) for k, v in p.items()},
                                    "b", jnp.asarray(x).astype(jd), st, 1e-6)
    ref = np.asarray(ref.astype(jnp.float32))
    args = _port_args(p, td, st)
    out = TW.window_msa(torch.from_numpy(x).to(td), *args, window=st.window,
                        shift=st.shift, eps=1e-6).float().numpy()
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype], err


def test_cpu_dispatch_is_the_plain_version():
    """On a CPU tensor the wrapper returns exactly the plain version and
    launches nothing."""
    p, x = _case(1, 1, 4, 32, 96)
    st = S.make_block_static(
        StageConfig(dim=96, depth=2, num_heads=3, grid=(4, 32), window=(2, 8),
                    shift=(1, 4), drop_path=(0.0, 0.0)), 1, (2, 8))
    args = _port_args(p, torch.float32, st)
    before = TW.window_msa.launches
    xt = torch.from_numpy(x)
    a = TW.window_msa(xt, *args, window=(2, 8), shift=(1, 4), eps=1e-6)
    b = TW.window_msa_ref(xt, *args, window=(2, 8), shift=(1, 4), eps=1e-6)
    assert torch.equal(a, b)
    assert TW.window_msa.launches == before


def test_kernel_addressing_is_roll_and_partition():
    """csrc/window_msa.cu reads token t of window (i, j) at
    ((i*wh + t//ww + sh) % H, (j*ww + t%ww + sw) % W); that must be the
    token roll(-s) followed by the window partition puts there."""
    H, W, wh, ww, sh, sw = 4, 32, 2, 8, 1, 4
    ids = torch.arange(H * W).reshape(1, H, W, 1)
    part = (torch.roll(ids, (-sh, -sw), (1, 2))
            .reshape(H // wh, wh, W // ww, ww).permute(0, 2, 1, 3)
            .reshape(-1, wh * ww))
    for win in range(part.shape[0]):
        i, j = divmod(win, W // ww)
        for t in range(wh * ww):
            row = (i * wh + t // ww + sh) % H
            col = (j * ww + t % ww + sw) % W
            assert part[win, t] == row * W + col


# ---------------------------------------------------------------------------
# The grouped and the natural entry points (K12, K13)
# ---------------------------------------------------------------------------

def _jax_common(p, jd):
    j = lambda k: jnp.asarray(p[f"b.{k}"]).astype(jd)
    return (j("norm1.weight").reshape(1, -1), j("norm1.bias").reshape(1, -1),
            j("attn.qkv.weight"), j("attn.qkv.bias").reshape(1, -1),
            j("attn.proj.weight"), j("attn.proj.bias").reshape(1, -1))


def _bias_big(p, st):
    """(nh, GL, GL) block-diagonal expansion of the gathered bias, as
    tulip_tpu/models/swin.py:470-474."""
    nh = st.num_heads
    bias = p["b.attn.relative_position_bias_table"][st.rel_index.reshape(-1)]
    bias = bias.reshape(16, 16, nh).transpose(2, 0, 1)
    wt = st.win_token
    return bias[:, wt[:, None], wt[None, :]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W,C,nh,shifted", [
    (4, 64, 96, 3, False), (4, 64, 96, 3, True),
    (4, 32, 192, 6, False), (4, 32, 192, 6, True)])
def test_grouped_entry_matches_jax_kernel_masked(dtype, H, W, C, nh, shifted):
    """fused_window_msa with heads <= 8 reaches window_msa.py:_kernel_masked
    (K12), fed the block-diagonal bias and the -1e9 group mask; the port's
    window_msa_grouped takes the compact (nh, 16, 16) / (nW, 16, 16) tables.
    B = 2: the mask of window n is mask[n % nW]."""
    from tulip_tpu.ops.pallas.window_msa import fused_window_msa
    B = 2
    p, x = _case(2, B, H, W, C)
    stage = StageConfig(dim=C, depth=2, num_heads=nh, grid=(H, W),
                        window=(2, 8), shift=(1, 4), drop_path=(0.0, 0.0))
    st = S.make_block_static(stage, int(shifted), (2, 8))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    G = st.group
    xt = torch.from_numpy(x).to(td)
    xg = TW.group_partition(xt, (2, 8), G)
    assert xg.shape == (B, (H // 2) * (W // 8 // G), G * 16, C)
    ref = fused_window_msa(
        jnp.asarray(xg.float().numpy()).astype(jd), *_jax_common(p, jd),
        jnp.asarray(_bias_big(p, st)), jnp.asarray(st.group_mask), nh=nh,
        scale_inv_sqrt_hd=32 ** -0.5, eps=1e-6)
    ref = np.asarray(ref.astype(jnp.float32))
    args = _port_args(p, td, st)
    before = TW.window_msa_grouped.launches
    out = TW.window_msa_grouped(xg, *args, eps=1e-6)
    assert TW.window_msa_grouped.launches == before
    assert out.shape == xg.shape and out.dtype == td
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype], err
    # and un-partitioned it is the default entry on the same (rolled) frame
    back = TW.group_unpartition(out, (H, W), (2, 8), G)
    same = TW.window_msa(xt, *args, window=(2, 8), shift=(0, 0), eps=1e-6)
    assert torch.equal(back, same)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shifted", [False, True])
def test_nat_entry_matches_jax_kernel_nat(dtype, shifted):
    """fused_window_msa_nat with 12 heads reaches window_msa.py:_kernel_nat
    (K13), fed bias and mask in natural token order; the port's
    window_msa_nat takes the compact tables."""
    from tulip_tpu.ops.pallas.attn_core import natural_token_perm
    from tulip_tpu.ops.pallas.window_msa import fused_window_msa_nat
    B, H, W, C, nh = 2, 4, 16, 384, 12
    p, x = _case(3, B, H, W, C)
    stage = StageConfig(dim=C, depth=2, num_heads=nh, grid=(H, W),
                        window=(2, 8), shift=(1, 4), drop_path=(0.0, 0.0))
    st = S.make_block_static(stage, int(shifted), (2, 8))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    perm = natural_token_perm(2, 8, st.group)
    bias_nat = _bias_big(p, st)[:, perm[:, None], perm[None, :]]
    gmask_nat = st.group_mask[:, perm[:, None], perm[None, :]]
    x4 = x.reshape(B * (H // 2), 2, W, C)
    ref = fused_window_msa_nat(
        jnp.asarray(x4).astype(jd), *_jax_common(p, jd),
        jnp.asarray(bias_nat), jnp.asarray(gmask_nat), nh=nh,
        scale_inv_sqrt_hd=32 ** -0.5, nH=H // 2, eps=1e-6)
    ref = np.asarray(ref.astype(jnp.float32))
    before = TW.window_msa_nat.launches
    out = TW.window_msa_nat(torch.from_numpy(x4).to(td),
                            *_port_args(p, td, st), nH=H // 2, eps=1e-6)
    assert TW.window_msa_nat.launches == before
    assert out.shape == x4.shape and out.dtype == td
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= TOL[dtype], err


def test_group_partition_is_the_jax_layout_and_inverts():
    """group_partition is swin.py:514-515; its windows come in the order of
    the plain window partition, so mask[n % nW] is window n's mask."""
    B, H, W, C, G = 2, 4, 64, 3, 4
    ids = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H, W, C)
    xg = TW.group_partition(ids, (2, 8), G)
    ref = (ids.numpy().reshape(B, H // 2, 2, W // 8 // G, G, 8, C)
           .transpose(0, 1, 3, 4, 2, 5, 6).reshape(B, -1, G * 16, C))
    np.testing.assert_array_equal(xg.numpy(), ref)
    assert torch.equal(TW.group_unpartition(xg, (H, W), (2, 8), G), ids)
    plain = (ids.reshape(B, H // 2, 2, W // 8, 8, C).permute(0, 1, 3, 2, 4, 5)
             .reshape(-1, 16, C))
    assert torch.equal(xg.reshape(-1, 16, C), plain)


def test_new_entries_refuse_other_devices_and_bad_shapes():
    m = lambda *s: torch.empty(*s, device="meta")
    w = (m(96), m(96), m(288, 96), m(288), m(96, 96), m(96), m(3, 16, 16))
    with pytest.raises(ValueError, match="cuda"):
        TW.window_msa_grouped(m(1, 2, 128, 96), *w, None, eps=1e-6)
    with pytest.raises(ValueError, match="cuda"):
        TW.window_msa_nat(m(2, 2, 16, 96), *w, None, nH=2, eps=1e-6)
    z = lambda *s: torch.zeros(*s)
    wz = (z(96), z(96), z(288, 96), z(288), z(96, 96), z(96), z(3, 16, 16))
    with pytest.raises(ValueError, match="whole"):
        TW.window_msa_grouped(z(1, 2, 24, 96), *wz, None, eps=1e-6)
    with pytest.raises(ValueError, match="whole images"):
        TW.window_msa_nat(z(3, 2, 16, 96), *wz, None, nH=2, eps=1e-6)


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's launch plan, row map and split sum
# (csrc/window_msa.cu window_msa_tc_kernel / window_msa_sum_kernel): the
# kernel runs only on the card, its plan and addressing are plain Python
# ---------------------------------------------------------------------------

SMEM_MAX = 232448                     # shared bytes a block can use on sm_90
# (tokens of one image, C, heads) of every stage
BASE_2048 = [(32 * 512, 96, 3), (16 * 256, 192, 6), (8 * 128, 384, 12),
             (4 * 64, 768, 24)]       # TULIP-base, 32 x 2048
LARGE_2048 = BASE_2048 + [(2 * 32, 1536, 48)]        # TULIP-large
BASE_256 = [(32 * 64, 96, 3), (16 * 32, 192, 6), (8 * 16, 384, 12),
            (4 * 8, 768, 24)]         # the W = 256 dry-run geometry
BASE_16x256 = [(16 * 64, 96, 3), (8 * 32, 192, 6), (4 * 16, 384, 12),
               (2 * 8, 768, 24)]      # the same with a 16-row input
PLAN_SHAPES = sorted({(t * b, c, nh)
                      for stages in (LARGE_2048, BASE_256, BASE_16x256)
                      for t, c, nh in stages for b in (1, 2, 8)})


def _min_splits(C, nh):
    """Fewest head splits whose block fits shared memory with 3 stages."""
    return next(s for s in range(1, nh + 1)
                if TW.plan_smem(C, -(-nh // s), 3) <= SMEM_MAX)


@pytest.mark.parametrize("T,C,nh", PLAN_SHAPES)
def test_plan_fits_and_covers(T, C, nh):
    p = TW.window_msa_plan(T, C, nh)
    assert p["rows"] == 64 and p["stages"] in (3, 4)
    assert p["smem"] == TW.plan_smem(C, p["hs"], p["stages"]) <= SMEM_MAX
    assert p["resident"] == (C <= 1024)
    # every head in exactly one split
    heads = [h for s in range(p["splits"])
             for h in range(s * p["hs"], min((s + 1) * p["hs"], nh))]
    assert heads == list(range(nh)) and p["hs"] * (p["splits"] - 1) < nh
    assert p["sum_launch"] == (p["splits"] > 1)
    # every token row in exactly one tile
    tiles = -(-T // p["rows"])
    rows = [r for t in range(tiles)
            for r in range(t * 64, min((t + 1) * 64, T))]
    assert rows == list(range(T))
    # no split beyond what shared memory forces where the rows fill the
    # card, nor at the byte-bound widths
    forced = _min_splits(C, nh)
    assert p["splits"] >= forced
    if tiles >= 132 or C < 384:
        assert p["splits"] == forced
        assert forced == 1 or C >= 768
    # the partial sums stay under the stated cap unless forced
    if p["splits"] > forced:
        assert p["splits"] * T * C * 4 <= TW.PARTIAL_CAP == 32 << 20


def test_plan_splits_more_where_rows_are_few():
    """Stage 3 (C 768, 24 heads): always at least the two splits that
    shared memory forces; about one CTA per SM below that."""
    assert _min_splits(768, 24) == 2 and _min_splits(384, 12) == 1
    b1, b8 = (TW.window_msa_plan(256 * b, 768, 24) for b in (1, 8))
    assert b1["splits"] > b8["splits"] >= 2
    for b, p in ((1, b1), (8, b8)):
        assert -(-256 * b // 64) * p["splits"] <= 132
    big = TW.window_msa_plan(256 * 64, 768, 24)      # 256 row tiles
    assert big["splits"] == 2


@pytest.mark.parametrize("nh", [1, 2, 5, 31, 32, 33, 64, 2048])
def test_plan_has_room_at_every_width(nh):
    """Up to C = 1,024 y stays resident and leaves room for 14 heads' ao;
    wider rows are streamed, so no width is refused for shared memory."""
    p = TW.window_msa_plan(64, 32 * nh, nh)
    assert 1 <= p["hs"] <= nh and p["smem"] <= SMEM_MAX
    assert p["resident"] == (nh <= 32)


@pytest.mark.parametrize("B,H,W,C,nh", [(2, 8, 128, 384, 12),
                                        (1, 4, 64, 768, 24),
                                        (2, 4, 64, 96, 3)])
def test_the_three_entries_take_one_plan(B, H, W, C, nh):
    """window_msa, window_msa_grouped and window_msa_nat hand _plan_args
    the same (T, C, nh) for the same tokens, so their split sums run in the
    same order; the scratch is what the plan says (bf16: window_msa_plan,
    fp32: window_msa_plan_f32, which streams y and takes no y scratch)."""
    x = torch.zeros(B, H, W, C, dtype=torch.bfloat16)
    params = [torch.zeros(s, dtype=torch.bfloat16)
              for s in ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,))]
    bias = torch.zeros(nh, 16, 16)
    xg = TW.group_partition(x, (2, 8), 8).contiguous()
    x4 = x.reshape(B * (H // 2), 2, W, C)
    n, Cg = TW._as_windows(xg, 16)
    Bn, Hn, Wn, Cn, window = TW._nat_grid(x4, bias, H // 2)
    assert (n * 16, Cg) == (Bn * Hn * Wn, Cn) == (B * H * W, C)
    assert window == (2, 8)
    plan = TW.window_msa_plan(B * H * W, C, nh)
    for t, T in ((x, B * H * W), (xg, n * 16), (x4, Bn * Hn * Wn)):
        y, partial, ints = TW._plan_args(t, T, C, nh, params)
        assert ints == (plan["hs"], plan["splits"], plan["stages"],
                        plan["smem"])
        assert y is None
        if plan["sum_launch"]:
            assert partial.shape == (plan["splits"], T, C)
            assert partial.dtype == torch.float32
        else:
            assert partial is None
    p32 = TW.window_msa_plan_f32(B * H * W, C, nh)
    y, partial, ints = TW._plan_args(x.float(), B * H * W, C, nh,
                                     [p.float() for p in params])
    assert y is None and ints == (p32["hs"], p32["splits"], p32["stages"],
                                  p32["smem"])
    if p32["sum_launch"]:
        assert partial.shape == (p32["splits"], B * H * W, C)
        assert partial.dtype == torch.float32
    else:
        assert partial is None


def test_plan_args_streams_a_wide_y_and_wants_aligned_operands():
    C, nh, T = 1536, 48, 64
    x = torch.zeros(1, 2, 32, C, dtype=torch.bfloat16)
    params = [torch.zeros(s, dtype=torch.bfloat16)
              for s in ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,))]
    y, partial, ints = TW._plan_args(x, T, C, nh, params)
    assert y.shape == (T, C) and y.dtype == torch.bfloat16
    assert partial.shape[0] == ints[1] > 1
    off = torch.zeros(C + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        TW._plan_args(x, T, C, nh, [off] + params[1:])


def _tile_row_map(B, H, W, wh, ww, sh, sw):
    """csrc/window_msa.cu msa_token_offset over whole 64-row tiles: tile row
    16 w + t of tile n is token t of window 4 n + w (windows counted over
    the batch), read at ((i wh + t / ww + sh) % H, (j ww + t % ww + sw) % W)
    of its image; -1 past the last token.  Returns (tiles, 64) flat token
    indices (offset / C)."""
    nWw, nW, T = W // ww, (H // wh) * (W // ww), B * H * W
    tiles = -(-T // 64)
    out = np.full((tiles, 64), -1, np.int64)
    for n in range(tiles):
        for w in range(4):
            for t in range(16):
                rg = n * 64 + 16 * w + t
                if rg >= T:
                    continue
                wg = rg >> 4
                b, win = divmod(wg, nW)
                i, j = divmod(win, nWw)
                row = (i * wh + t // ww + sh) % H
                col = (j * ww + t % ww + sw) % W
                out[n, 16 * w + t] = (b * H + row) * W + col
    return out


@pytest.mark.parametrize("B,H,W,window,shift", [
    (1, 2, 8, (2, 8), (0, 0)),       # 16 tokens: a quarter tile
    (1, 4, 8, (2, 8), (1, 4)),       # 32 tokens, the shift wraps both axes
    (3, 2, 8, (2, 8), (0, 0)),       # 48 tokens, a tile across images
    (5, 2, 8, (2, 8), (0, 0)),       # 80 tokens: last tile holds 16
    (1, 4, 16, (2, 8), (1, 4)),      # one whole tile, wrapping both axes
    (2, 4, 32, (2, 8), (1, 4)),      # 4 tiles, two images
    (2, 3, 16, (1, 16), (0, 0)),     # the grouped entry's geometry
])
def test_tile_row_map_is_roll_and_partition(B, H, W, window, shift):
    wh, ww = window
    sh, sw = shift
    ids = torch.arange(B * H * W).reshape(B, H, W)
    part = (torch.roll(ids, (-sh, -sw), (1, 2))
            .reshape(B, H // wh, wh, W // ww, ww).permute(0, 1, 3, 2, 4)
            .reshape(-1).numpy())                      # window-major tokens
    got = _tile_row_map(B, H, W, wh, ww, sh, sw)
    T = B * H * W
    flat = got.reshape(-1)
    np.testing.assert_array_equal(flat[:T], part)
    assert (flat[T:] == -1).all() and flat.size == -(-T // 64) * 64
    # every token is read (and written back) exactly once
    assert sorted(flat[:T]) == list(range(T))
    # a tile's rows 16 w .. 16 w + 15 are one window: one image, wh rows
    for tile in got:
        for w in range(4):
            rows = tile[16 * w:16 * w + 16]
            if rows[0] < 0:
                assert (rows < 0).all()
                continue
            assert len({r // (H * W) for r in rows}) == 1
            assert len({(r // W) % H for r in rows}) == wh


@pytest.mark.parametrize("C,nh,hs", [(96, 3, 1), (384, 12, 3), (384, 12, 5),
                                     (768, 24, 6)])
def test_split_order_sum_is_the_unsplit_proj(C, nh, hs):
    """What window_msa_sum_kernel must reproduce: proj as a sum over head
    splits, added in split order in fp32, then + bias + x, against the
    unsplit half-block.  fp32 summation order only: 1e-6 of max|ref|."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        p, x = _case(4, 1, 4, 16, C)
        stage = StageConfig(dim=C, depth=2, num_heads=nh, grid=(4, 16),
                            window=(2, 8), shift=(1, 4),
                            drop_path=(0.0, 0.0))
        st = S.make_block_static(stage, 1, (2, 8))
        lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask = _port_args(
            p, torch.float32, st)
        xt = torch.from_numpy(x)
        ref = TW.window_msa_ref(xt, lnw, lnb, wqkv, bqkv, wproj, bproj, bias,
                                mask, window=(2, 8), shift=(1, 4), eps=1e-6)
        # the head outputs in window-major order, as the kernel's ao tiles
        xw = (torch.roll(xt, (-1, -4), (1, 2)).reshape(1, 2, 2, 2, 8, C)
              .permute(0, 1, 3, 2, 4, 5).reshape(-1, 16, C))
        y = TW.layer_norm(xw, lnw, lnb, 1e-6)
        q, k, v = (TW.linear(y, wqkv, bqkv).reshape(-1, 16, 3, nh, 32)
                   .permute(2, 0, 3, 1, 4).unbind(0))
        logits = q @ k.transpose(-1, -2) * 32 ** -0.5 + bias
        logits = logits + mask[:, None]
        o = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(-1, C)
        total = torch.zeros(o.shape[0], C)
        for s in range(-(-nh // hs)):                   # split order
            cols = slice(32 * hs * s, min(32 * hs * (s + 1), C))
            total = total + o[:, cols] @ wproj[:, cols].T
        out = (total + bproj + xw.reshape(-1, C)).reshape(1, 2, 2, 2, 8, C)
        out = torch.roll(out.permute(0, 1, 3, 2, 4, 5).reshape(1, 4, 16, C),
                         (1, 4), (1, 2))
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err <= 1e-6, err
    finally:
        torch.set_num_threads(threads)


def test_kernel_refuses_other_windows_and_head_dims():
    z = torch.zeros
    w = (z(96), z(96), z(288, 96), z(288), z(96, 96), z(96))
    with pytest.raises(NotImplementedError, match="head dim 32"):
        TW._check(z(1, 4, 8, 96), 96, 2, 16, w, z(2, 16, 16), None, 2)
    with pytest.raises(NotImplementedError, match="16-token"):
        TW._check(z(1, 4, 8, 96), 96, 3, 32, w, z(3, 32, 32), None, 1)
