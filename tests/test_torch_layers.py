"""The port's primitives against the JAX package: attention statics, grid
rolls, circular padding, LayerNorm, GELU, weight layouts; plus the port's
import and dispatch rules (no jax import, no fallback when nvcc is absent,
no other device than cpu and cuda)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.models import layers as JL
from tulip_tpu.parallel import halo as JH
from tulip_tpu_torch.models import layers as TL
from tulip_tpu_torch.ops import build
from tulip_tpu_torch.ops import mlp as TM
from tulip_tpu_torch.ops import window_msa as TW
from tulip_tpu_torch.parallel import halo as TH


@pytest.mark.parametrize("window", [(2, 8), (1, 16), (3, 5)])
def test_relative_position_index_equals_jax(window):
    np.testing.assert_array_equal(TL.relative_position_index(window),
                                  JL.relative_position_index(window))


@pytest.mark.parametrize("grid,window,shift", [
    ((32, 512), (2, 8), (1, 4)), ((4, 64), (2, 8), (1, 4)),
    ((1, 32), (1, 16), (0, 8)), ((6, 20), (3, 5), (1, 2))])
def test_shift_attention_mask_equals_jax(grid, window, shift):
    np.testing.assert_array_equal(TL.shift_attention_mask(grid, window, shift),
                                  JL.shift_attention_mask(grid, window, shift))


@pytest.mark.parametrize("sh,sw", [(1, 4), (-1, -4), (0, 3), (0, 0)])
def test_roll_hw_equals_jax(sh, sw):
    x = np.random.default_rng(0).normal(size=(2, 4, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TH.roll_hw(torch.from_numpy(x), sh, sw).numpy(),
        np.asarray(JH.roll_hw(jnp.asarray(x), sh, sw)))


def test_circular_pad_w_equals_jax():
    x = np.random.default_rng(1).normal(size=(2, 4, 16, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        TH.circular_pad_w(torch.from_numpy(x), 2, 2).numpy(),
        np.asarray(JH.circular_pad_w(jnp.asarray(x), 2, 2)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_layer_norm_and_gelu_match_jax(dtype, tol):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (64, 96)).astype(np.float32)
    w = rng.normal(1, 0.1, (96,)).astype(np.float32)
    b = rng.normal(0, 0.1, (96,)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    ref = JL.layer_norm({"n.weight": jnp.asarray(w), "n.bias": jnp.asarray(b)},
                        "n", jnp.asarray(x).astype(jd), 1e-6)
    out = TL.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w),
                        torch.from_numpy(b), 1e-6)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= tol * np.abs(ref).max()
    g_ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    g = TL.gelu(torch.from_numpy(x).to(td)).float().numpy()
    assert np.abs(g - g_ref).max() <= tol * np.abs(g_ref).max()


def test_init_params_match_jax_keys_and_layouts():
    """Same keys as the JAX init; torch layouts: linear (out, in), conv
    OIHW; initial LayerNorms are ones/zeros in both."""
    from tulip_tpu.config import model_config
    from tulip_tpu.models.tulip import init_params as jax_init
    from tulip_tpu_torch.models.tulip import init_params
    from tulip_tpu_torch.utils.checkpoint import state_dict_from_jax
    cfg = model_config("tulip_base", img_size=(32, 256),
                       target_img_size=(128, 256), pixel_shuffle=True,
                       circular_padding=True, patch_unmerging=True)
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    theirs = state_dict_from_jax(
        {k: np.asarray(v) for k, v in jax_init(jax.random.PRNGKey(0),
                                               cfg).items()})
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        if ".norm" in k or k.startswith("norm_up"):
            torch.testing.assert_close(ours[k], theirs[k])
    assert ours["layers.0.blocks.1.attn.qkv.weight"].shape == (288, 96)
    assert ours["ps_head.conv_expand.0.weight"].shape == (1536, 96, 1, 1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# imports every module of the port and chip_smoke, then fails if anything of
# JAX or of the JAX package came along
IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
import tulip_tpu_torch
names = ['tulip_tpu_torch', 'chip_smoke'] + [
    m.name for m in pkgutil.walk_packages(tulip_tpu_torch.__path__,
                                          'tulip_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ('jax', 'jaxlib', 'optax', 'tulip_tpu')
             or k.startswith(('tulip_tpu.', 'jax.', 'jaxlib.', 'optax.')))
print(len(names), 'modules imported:', ' '.join(names))
sys.exit('imported: %s' % bad if bad else 0)
"""


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke, imports jax, jaxlib, optax or
    anything of the JAX package, directly or through another module."""
    proc = subprocess.run([sys.executable, "-c", IMPORT_EVERYTHING], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 53
    for name in ("models.swin_v2_classifier", "utils.lars", "utils.lr_decay",
                 "utils.pos_embed", "utils.filter", "utils.crop"):
        assert f"tulip_tpu_torch.{name}" in proc.stdout, name


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No CPU fallback: without nvcc the kernel build raises and names
    where it looked."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found; searched .*"
                                          "/usr/local/cuda/bin/nvcc"):
        build.load()


def test_wrappers_refuse_other_devices():
    """A tensor on neither cpu nor cuda raises instead of taking a path."""
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        TW.window_msa(m(1, 2, 8, 96), m(96), m(96), m(288, 96), m(288),
                      m(96, 96), m(96), m(3, 16, 16), None, window=(2, 8),
                      shift=(0, 0), eps=1e-6)
    with pytest.raises(ValueError, match="cuda"):
        TM.fused_ln_mlp(m(16, 96), m(96), m(96), m(384, 96), m(384),
                        m(96, 384), m(96))
    with pytest.raises(ValueError, match="cuda"):
        TM.fused_ln_linear(m(16, 384), m(384), m(384), m(192, 384))
