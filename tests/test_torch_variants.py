"""The model variants beyond the flagship (tulip_tpu_torch.models: Swin-v2
blocks and PatchMergingV2, the PatchExpanding upsample, the
FinalPatchExpanding head; TULIP-large) against the JAX package, fp32 on
the CPU, both packages built from one JAX ``init_params(PRNGKey(0))``
carried into the port with ``load_jax_params`` (strict).

- blocks: SwinBlockV2 (shifted and not), PatchMergingV2, PatchExpanding
  (the bottleneck's and a decoder stage's), FinalPatchExpanding, and the
  v1 block's dropout composition with its draws off, each against its JAX
  function on the same seeded input, within 1e-5 of max|ref|;
- whole model, mode "eval": v2 with the flagship heads, v1 and v2 with
  the default heads (TULIP-base 16x256 -> 64x256) and TULIP-large with the
  flags of bash_scripts/tulip_upsampling_carla.sh (32x512 -> 128x512, the
  smallest width whose five stages each hold a whole 2 x 8 window), within
  1e-5 of max|ref|;
- keys: the port's ``init_params`` gives JAX's keys and shapes for every
  variant; the weights cross both ways through ``state_dict_from_jax`` /
  ``jax_params_from_state_dict``, from the JAX package's native file, and
  from a reference-layout ``.pth`` (with the buffers the reference keeps).

The gradients, the dropout sites and data parallel with dropout are in
test_torch_variants_train.py; sequence parallel, MC dropout and the
command line in test_torch_variants_runs.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tulip_tpu.config import model_config
from tulip_tpu.models import swin as JS
from tulip_tpu.models import tulip as JT
from tulip_tpu_torch.config import model_config as port_config
from tulip_tpu_torch.models import tulip as TT
from tulip_tpu_torch.utils import checkpoint as TC

BASE = dict(img_size=(16, 256), target_img_size=(64, 256), patch_size=(1, 4),
            window_size=(2, 8), circular_padding=True, log_transform=True)
HEADS = dict(pixel_shuffle=True, patch_unmerging=True)
DEFAULT_HEADS = dict(pixel_shuffle=False, patch_unmerging=False)
VARIANTS = {"v2": dict(BASE, swin_v2=True, **HEADS),
            "v1_default_heads": dict(BASE, swin_v2=False, **DEFAULT_HEADS),
            "v2_default_heads": dict(BASE, swin_v2=True, **DEFAULT_HEADS)}
# bash_scripts/tulip_upsampling_carla.sh's model at the smallest width
LARGE = dict(BASE, img_size=(32, 512), target_img_size=(128, 512), **HEADS)
EPS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: several test processes share the machine's cores
    (as in test_torch_cli.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_pair(select, kw, seed=0):
    """(JAX cfg, JAX params, the port's model with those weights)."""
    cfg = model_config(select, **kw)
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    model = TT.TULIP(port_config(select, **kw))
    TC.load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    return cfg, params, model


@pytest.fixture(scope="module")
def pairs():
    return {name: make_pair("tulip_base", kw)
            for name, kw in VARIANTS.items()}


def _close(got, ref, limit=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= limit, err


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage,block", [(0, 0), (0, 1), (1, 1)])
def test_swin_block_v2_matches_jax(pairs, stage, block):
    """Block 1 of a stage is shifted (and masked), block 0 not."""
    cfg, params, model = pairs["v2"]
    st = JT.build_model(cfg).enc_blocks[stage][block]
    H, W = st.grid
    x = _rand((2, H, W, cfg.encoder_stages[stage].dim), stage * 2 + block)
    ref = JS.swin_block_v2(params, f"layers.{stage}.blocks.{block}",
                           jnp.asarray(x), st, eps=EPS)
    got = model.layers[stage].blocks[block](torch.from_numpy(x))
    _close(got, ref)


def test_patch_merging_v2_matches_jax(pairs):
    cfg, params, model = pairs["v2"]
    H, W = cfg.encoder_stages[0].grid
    x = _rand((2, H, W, cfg.embed_dim), 7)
    ref = JT._patch_merging(params, "layers.0.downsample", jnp.asarray(x),
                            True, EPS)
    _close(model.layers[0].downsample(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("prefix", ["first_patch_expanding",
                                    "layers_up.0.upsample"])
def test_patch_expanding_matches_jax(pairs, prefix):
    cfg, params, model = pairs["v1_default_heads"]
    dim = (cfg.embed_dim * 2 ** (cfg.num_layers - 1)
           if prefix == "first_patch_expanding"
           else cfg.decoder_stages[0].dim)
    x = _rand((2, 2, 8, dim), 8)
    ref = JT._patch_expanding(params, prefix, jnp.asarray(x), EPS)
    mod = (model.first_patch_expanding if prefix == "first_patch_expanding"
           else model.layers_up[0].upsample)
    _close(mod(torch.from_numpy(x)), ref)


def test_final_patch_expanding_matches_jax(pairs):
    cfg, params, model = pairs["v2_default_heads"]
    x = _rand((2, 4, 16, cfg.embed_dim), 9)
    ref = JT._final_patch_expanding(params, jnp.asarray(x), cfg)
    _close(model.final_patch_expanding(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("drop,attn_drop", [(0.1, 0.1), (0.0, 0.1)])
@pytest.mark.parametrize("block", [0, 1])
def test_v1_dropout_composition_with_draws_off_matches_jax(drop, attn_drop,
                                                           block):
    """The v1 block's dropout branch (taken at non-zero rates) with no
    generator, so no site draws, against JAX's swin_block_v1 on the XLA
    path: the attention composition, and the MLP composition where
    drop_rate > 0, else the two-matmul half."""
    kw = dict(BASE, **HEADS, depths=(2, 2), num_heads=(3, 6),
              drop_rate=drop, attn_drop_rate=attn_drop)
    cfg, params, model = make_pair("tulip_base", kw)
    st = JT.build_model(cfg).enc_blocks[0][block]
    H, W = st.grid
    x = _rand((2, H, W, cfg.embed_dim), 10 + block)
    ref = JS.swin_block_v1(params, f"layers.0.blocks.{block}",
                           jnp.asarray(x), st, eps=EPS, attn_impl="xla")
    blk = model.layers[0].blocks[block]
    got = blk._forward_dropout(torch.from_numpy(x), False, None)
    _close(got, ref)
    # and the block takes that branch in mode "mc" / "train" only
    seen = []
    orig = blk._forward_dropout
    blk._forward_dropout = lambda *a: seen.append(1) or orig(*a)
    blk(torch.from_numpy(x))
    assert not seen
    blk(torch.from_numpy(x), dropout=True)
    assert seen == [1]


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

def _forward_matches(cfg, params, model, x, t):
    jpred, jloss, _ = JT.apply_model(
        params, JT.build_model(cfg), jnp.asarray(x), jnp.asarray(t),
        mode="eval", compute_dtype=jnp.float32)
    pred, loss, _ = TT.apply_model(model, torch.from_numpy(x),
                                   torch.from_numpy(t), mode="eval")
    assert pred.shape == (x.shape[0], 1) + tuple(cfg.target_img_size)
    _close(pred, jpred)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_whole_model_fp32_matches_jax(pairs, name):
    cfg, params, model = pairs[name]
    _forward_matches(cfg, params, model,
                     np.random.default_rng(0).uniform(
                         0, 1, (2, 1, 16, 256)).astype(np.float32),
                     np.random.default_rng(1).uniform(
                         0, 1, (2, 1, 64, 256)).astype(np.float32))


def test_tulip_large_fp32_matches_jax():
    cfg, params, model = make_pair("tulip_large", LARGE)
    assert cfg.num_layers == 5 and cfg.encoder_stages[-1].num_heads == 48
    _forward_matches(cfg, params, model,
                     np.random.default_rng(2).uniform(
                         0, 1, (1, 1, 32, 512)).astype(np.float32),
                     np.random.default_rng(3).uniform(
                         0, 1, (1, 1, 128, 512)).astype(np.float32))


# ---------------------------------------------------------------------------
# keys and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swin_v2", [False, True])
@pytest.mark.parametrize("heads", ["flagship", "default"])
@pytest.mark.parametrize("select", ["tulip_base", "tulip_large"])
def test_init_params_keys_and_shapes_equal_jax(swin_v2, heads, select):
    kw = dict(BASE, swin_v2=swin_v2,
              **(HEADS if heads == "flagship" else DEFAULT_HEADS))
    if select == "tulip_large":
        kw.update(img_size=(32, 512), target_img_size=(128, 512))
    cfg = model_config(select, **kw)
    jshapes = {k: tuple(v.shape) for k, v in
               jax.eval_shape(lambda: JT.init_params(
                   jax.random.PRNGKey(0), cfg)).items()}
    ours = TT.init_params(port_config(select, **kw),
                          torch.Generator().manual_seed(0))
    # the port keeps torch layouts: compare in JAX's
    converted = TC.jax_params_from_state_dict(ours)
    assert {k: v.shape for k, v in converted.items()} == jshapes
    model = TT.TULIP(port_config(select, **kw))
    model.load_state_dict(ours, strict=True)


def test_weights_cross_both_ways(pairs, tmp_path):
    """Every key of a v2 model with the default heads (all the new ones):
    JAX -> port -> JAX is exact; the JAX package's native file and a
    reference-layout .pth (with the relative_coords_table /
    relative_position_index buffers the reference keeps, which JAX's
    import_torch_state_dict drops) load into the port with the same
    forward; JAX's importer reads the port's state dict as JAX's params."""
    from tulip_tpu.utils import checkpoint as JC
    cfg, params, model = pairs["v2_default_heads"]
    jp = {k: np.asarray(v) for k, v in params.items()}
    sd = model.state_dict()
    back = TC.jax_params_from_state_dict(sd)
    assert set(back) == set(jp)
    for k in jp:
        assert np.array_equal(back[k], jp[k]), k
    imported = JC.import_torch_state_dict(sd)
    assert set(imported) == set(jp)
    assert all(np.array_equal(imported[k], jp[k]) for k in jp)
    assert any(k.endswith("attn.logit_scale") for k in sd)

    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (1, 1, 16, 256)).astype(np.float32))
    ref = TT.apply_model(model, x, mode="eval", mc_drop=True)
    ref_layout = dict(sd)
    for name, buf in model.named_buffers():
        if name.endswith(("relative_coords_table", "relative_position_index")):
            ref_layout[name] = buf
    assert any(k.endswith("relative_coords_table") for k in ref_layout)
    torch.save({"model": ref_layout, "epoch": 3}, tmp_path / "ref.pth")
    JC.save_checkpoint(str(tmp_path / "native.ckpt"), params, epoch=3)
    for path in ("ref.pth", "native.ckpt"):
        ckpt = TC.load_checkpoint(str(tmp_path / path))
        fresh = TT.TULIP(model.cfg)
        fresh.load_state_dict(ckpt["model"], strict=True)
        assert torch.equal(TT.apply_model(fresh, x, mode="eval",
                                          mc_drop=True), ref), path
