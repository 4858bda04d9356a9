"""The port's auxiliary utils (tulip_tpu_torch/utils/{lars,lr_decay,
pos_embed,filter,crop}.py) against the JAX package's, on the CPU:

- LARS over three steps equals the optax transformation, parameters within
  1e-6 (fp32 summation order of the two norms);
- the lr-decay parameter groups under SGD equal optax's
  chain(scale_by_lr_tree, sgd) over one step within 1e-7; the layer ids
  and scales equal;
- the sin-cos position embeddings and their interpolation bit-equal;
- the Sobel edge filters within 1e-6 of max|ref| of JAX's convolution
  (nine fp32 products summed in another order);
- RandomResizedCrop on an explicit RandomState equal, bit for bit, to the
  JAX package's transform drawing from numpy's global state on the same
  seed.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from tulip_tpu.utils import crop as JC
from tulip_tpu.utils import filter as JF
from tulip_tpu.utils import lars as JLARS
from tulip_tpu.utils import lr_decay as JD
from tulip_tpu.utils import pos_embed as JP
from tulip_tpu_torch.utils import crop as TC
from tulip_tpu_torch.utils import filter as TF
from tulip_tpu_torch.utils import lars as TLARS
from tulip_tpu_torch.utils import lr_decay as TD
from tulip_tpu_torch.utils import pos_embed as TP


def _params_and_grads(seed):
    """A weight matrix, a bias, a zero matrix (the trust ratio's guard) and
    three steps of gradients, numpy fp32."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(8, 6)).astype(np.float32),
              "b": rng.normal(size=(6,)).astype(np.float32),
              "z": np.zeros((4, 4), np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("wd,momentum", [(0.0, 0.9), (1e-2, 0.9),
                                         (1e-4, 0.0)])
def test_lars_equals_the_optax_transform(wd, momentum):
    params, grads = _params_and_grads(0)
    tx = JLARS.lars(learning_rate=0.1, weight_decay=wd, momentum=momentum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = TLARS.LARS(tp.values(), lr=0.1, weight_decay=wd, momentum=momentum)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the zero matrix moved too: where ||p|| is 0 the trust ratio is 1
    assert not np.array_equal(tp["z"].detach().numpy(), params["z"])


def test_lr_decay_ids_and_scales_equal_jax():
    names = ["patch_embed.proj.weight", "layers.0.blocks.0.mlp.fc1.weight",
             "layers.2.blocks.1.attn.qkv.weight", "layers_up.0.blocks.0.x",
             "norm_up.weight", "decoder_pred.weight"]
    for n in names:
        assert TD.get_layer_id(n, 4) == JD.get_layer_id(n, 4)
    assert TD.lr_scale_tree(names, 4, 0.6) == JD.lr_scale_tree(
        dict.fromkeys(names), 4, 0.6)


def test_lr_decay_groups_equal_scale_by_lr_tree_and_sgd():
    rng = np.random.default_rng(1)
    names = ["patch_embed.proj.weight", "layers.0.blocks.0.mlp.fc1.weight",
             "layers.1.downsample.reduction.weight",
             "layers.1.blocks.0.norm1.bias", "norm_up.weight",
             "decoder_pred.weight"]
    params = {n: rng.normal(size=(4, 3)).astype(np.float32) for n in names}
    grads = {n: rng.normal(size=(4, 3)).astype(np.float32) for n in names}
    tx = optax.chain(JD.scale_by_lr_tree(JD.lr_scale_tree(params, 4, 0.5)),
                     optax.sgd(0.05))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    upd, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                       tx.init(jp), jp)
    jp = optax.apply_updates(jp, upd)
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for n, v in params.items()}
    groups = TD.param_groups(tp.items(), 4, 0.05, layer_decay=0.5)
    assert [g["lr_scale"] for g in groups] == [0.5 ** 4, 0.5 ** 3, 0.5 ** 2,
                                               1.0]
    assert sorted(n for g in groups for n in g["names"]) == sorted(names)
    opt = torch.optim.SGD(groups, lr=0.05)
    for n, p in tp.items():
        p.grad = torch.from_numpy(grads[n])
    opt.step()
    for n, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   rtol=0, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("dim,grid,cls", [(64, (4, 8), True), (32, 6, False),
                                          (16, (3, 5), True)])
def test_pos_embed_bit_equal(dim, grid, cls):
    ours = TP.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    theirs = JP.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    old = grid if isinstance(grid, tuple) else (grid, grid)
    new = (2 * old[0] + 1, old[1] + 3)
    extra = int(cls)
    np.testing.assert_array_equal(
        TP.interpolate_pos_embed(ours[None], new, old, extra),
        JP.interpolate_pos_embed(theirs[None], new, old, extra))


def test_edge_filters_equal_jax():
    x = np.random.default_rng(2).normal(size=(2, 1, 12, 20)).astype(
        np.float32)
    x[:, :, 6:, :] += 3.0
    for tfn, tmod, jfn in (
            (TF.horizontal_edges, TF.HorizontalEdgeDetectionCNN(),
             JF.horizontal_edges),
            (TF.vertical_edges, TF.VerticalEdgeDetectionCNN(),
             JF.vertical_edges)):
        ref = np.asarray(jfn(jnp.asarray(x)))
        out = tfn(torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape == x.shape
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
        assert torch.equal(tmod(torch.from_numpy(x)), tfn(torch.from_numpy(x)))


@pytest.mark.parametrize("size,shape", [((16, 32), (1, 64, 128)),
                                        (24, (2, 40, 60))])
def test_random_resized_crop_equals_jax_on_one_seed(size, shape):
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    theirs_t = JC.RandomResizedCrop(size)
    np.random.seed(7)
    theirs = [theirs_t(img) for _ in range(4)]
    ours_t = TC.RandomResizedCrop(size, rng=np.random.RandomState(7))
    ours = [ours_t(img) for _ in range(4)]
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ours[0], ours[1])
    assert isinstance(TC.RandomResizedCrop(8).rng, np.random.RandomState)
