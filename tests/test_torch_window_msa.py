"""The port's window-MSA half-block (tulip_tpu_torch.ops.window_msa) against
the JAX package's fused half-block, whose Pallas kernels run in interpret
mode on the CPU: window_msa.py:_kernel_masked_nat for heads <= 8 (K1) and
window_msa.py:_kernel for heads > 8 (K2).

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
