"""The Swin-v2 image classifier of the port
(tulip_tpu_torch/models/swin_v2_classifier.py) against the JAX package's
(tulip_tpu/models/swin_v2_classifier.py) on the CPU, at the JAX test's
size (embed 48, depths (2, 2), heads (3, 6), window 4, 10 classes):

- the port's init has the JAX init's keys and shapes (both under
  ``state_dict_from_jax``, which leaves the classifier's ``head`` and the
  3-D ``logit_scale`` as they are) and loads strict;
- fp32 logits from the JAX weights (``state_dict_from_jax``) within 1e-5
  of max|ref| of ``apply_swin_v2`` under
  ``jax.default_matmul_precision("highest")`` (summation order only), at
  32 x 32 (the second stage's 4 x 4 grid takes the window whole) and 64 x
  64 (both stages windowed and shifted), with 3 and 1 input channels, and
  without the qkv bias;
- the window clamp where the grid is smaller than the window: 24 x 24 at
  window 8 (grids 6 and 3 become the windows, unshifted);
- the bf16 forward within 3e-2 of max|ref| of JAX's fp32 logits;
- the CPU path launches no kernel, and the factory's default device is the
  GPU.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.models import swin_v2_classifier as JC
from tulip_tpu_torch.models import swin_v2_classifier as TC
from tulip_tpu_torch.ops import ln as TLN
from tulip_tpu_torch.ops import mlp as TM
from tulip_tpu_torch.utils.checkpoint import state_dict_from_jax

SMALL = dict(patch_size=4, num_classes=10, embed_dim=48, depths=(2, 2),
             num_heads=(3, 6), drop_path_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: several test processes share the machine's cores
    (as in test_torch_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(img, in_chans=3, window=4, qkv_bias=True, seed=0):
    kw = dict(SMALL, img_size=img, in_chans=in_chans, window_size=window,
              qkv_bias=qkv_bias)
    jm = JC.build_swin_v2(**kw)
    params = JC.init_swin_v2_params(jax.random.PRNGKey(seed), jm)
    model = TC.build_swin_v2(**kw, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in params.items()}), strict=True)
    x = np.random.default_rng(seed).standard_normal(
        (2, in_chans) + tuple(img)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JC.apply_swin_v2(params, jm, jnp.asarray(x)))
    return jm, model, x, ref


@pytest.mark.parametrize("in_chans,qkv_bias", [(3, True), (1, True),
                                               (3, False)])
def test_init_keys_and_shapes_equal_jax(in_chans, qkv_bias):
    kw = dict(SMALL, img_size=(32, 32), in_chans=in_chans, window_size=4,
              qkv_bias=qkv_bias)
    theirs = state_dict_from_jax(
        {k: np.asarray(v) for k, v in JC.init_swin_v2_params(
            jax.random.PRNGKey(0), JC.build_swin_v2(**kw)).items()})
    model = TC.build_swin_v2(**kw, device="cpu")
    ours = TC.init_swin_v2_params(model, torch.Generator().manual_seed(0))
    assert set(ours) == set(theirs)
    assert ("layers.0.blocks.0.attn.q_bias" in ours) == qkv_bias
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        if ".norm" in k or k.startswith("norm.") or k.endswith(
                ("logit_scale", "q_bias", "v_bias")):
            torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    assert ours["head.weight"].shape == (10, 96)
    assert ours["layers.1.blocks.0.attn.logit_scale"].shape == (6, 1, 1)
    assert ours["patch_embed.proj.weight"].shape == (48, in_chans, 4, 4)
    model.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("img,in_chans,qkv_bias", [
    ((32, 32), 3, True), ((64, 64), 3, True), ((32, 32), 1, True),
    ((64, 64), 1, False), ((32, 32), 3, False)])
def test_fp32_logits_equal_jax(img, in_chans, qkv_bias):
    _, model, x, ref = _pair(img, in_chans, qkv_bias=qkv_bias)
    before = (TM.fused_two_matmul.launches, TLN.ln_fwd.launches)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert (TM.fused_two_matmul.launches, TLN.ln_fwd.launches) == before
    assert out.shape == (2, 10) and out.dtype == torch.float32
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


def test_window_clamps_to_a_grid_smaller_than_the_window():
    jm, model, x, ref = _pair((24, 24), window=8)
    assert [blk.window for blk in (s[0] for s in model.stages)] == \
        [(6, 6), (3, 3)]
    assert all(blk.shift == (0, 0) for s in model.stages for blk in s)
    assert [[(b.window, b.shift) for b in s] for s in model.stages] == \
        [[(b.window, b.shift) for b in s] for s in jm.stages]
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_shifted_stage_geometry_equals_jax():
    jm = JC.build_swin_v2(**dict(SMALL, img_size=(64, 64), window_size=4))
    model = TC.build_swin_v2(**dict(SMALL, img_size=(64, 64),
                                    window_size=4), device="cpu")
    for ours, theirs in zip(model.stages, jm.stages):
        for a, b in zip(ours, theirs):
            assert (a.grid, a.window, a.shift) == (b.grid, b.window, b.shift)
            np.testing.assert_array_equal(a.rel_index, b.rel_index)
            assert (a.mask is None) == (b.mask is None)
            if a.mask is not None:
                np.testing.assert_array_equal(a.mask, b.mask)


def test_bf16_logits_near_jax_fp32():
    _, model, x, ref = _pair((32, 32))
    with torch.no_grad():
        out = model.to(torch.bfloat16)(
            torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 3e-2, err


def test_default_device_is_the_gpu():
    import inspect
    sig = inspect.signature(TC.build_swin_v2)
    assert sig.parameters["device"].default == "cuda"
    jsig = inspect.signature(JC.build_swin_v2)
    for name, p in jsig.parameters.items():
        assert sig.parameters[name].default == p.default, name
