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
