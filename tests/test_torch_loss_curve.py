"""The port's 120-step loss curve against the JAX package's, on the CPU.

The setup of BASELINE.md:64-89 (the JAX package's record against the
reference; its JAX curve went 0.3934 -> 0.1166): TULIP-base with the
flags of the shipped scripts at 16x256 -> 64x256, batch 2, 8 fixed
synthetic batches (log-space high-resolution scans and their strided
rows, from one numpy seed), AdamW (0.9, 0.95), weight decay 0.05, lr
5e-4 with a 1-epoch warm-up and the per-iteration cosine schedule, 120
steps.  Both packages start from one ``init_params`` (the JAX package's,
carried across with ``utils/checkpoint.py:state_dict_from_jax``); JAX runs
``tulip_tpu.train.step.make_train_step``, the port ``train/step.py`` on
its plain versions, both in ``dtype``.  Drop-path is 0: the two packages'
random streams differ, and with it on the per-step gap would be that of
two draws, not that of the arithmetic.

Gate, as there: both curves descend (the last 20 steps' mean below 0.7 of
the first 20's) and the last-20 means lie within 15 %.  The test prints
the per-step gap at steps 0 / 24 / 48 / 72 / 96 / 119 (the loss gap and
the largest weight difference over lr) and the last-20 means, the table
of PERF.md §6.  Slow (minutes of CPU a dtype):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_loss_curve.py -m slow -s -q
"""

import json

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

STEPS, PER_EPOCH, BATCH, LR, WD = 120, 8, 2, 5e-4, 0.05
LOW, HIGH = (16, 256), (64, 256)
ROWS = (0, 24, 48, 72, 96, 119)
WINDOW = 20
KW = dict(img_size=LOW, target_img_size=HIGH, patch_size=(1, 4),
          window_size=(2, 8), pixel_shuffle=True, circular_padding=True,
          log_transform=True, patch_unmerging=True, drop_path_rate=0.0)


def _batches(seed=0):
    """Learnable pairs: log-space scans and every 4th row of them (the
    production downsampling relation)."""
    rng = np.random.default_rng(seed)
    factor = HIGH[0] // LOW[0]
    out = []
    for _ in range(PER_EPOCH):
        h = np.log1p(rng.uniform(0.05, 0.95, (BATCH, 1) + HIGH)).astype(
            np.float32)
        out.append((np.ascontiguousarray(h[:, :, ::factor]), h))
    return out


def _lrs():
    from tulip_tpu_torch.utils.lr_sched import lr_at_epoch
    epochs = -(-STEPS // PER_EPOCH)
    return [lr_at_epoch(i / PER_EPOCH, LR, 0.0, 1, epochs)
            for i in range(STEPS)]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_the_port_tracks_the_jax_loss_curve(dtype):
    import jax
    import jax.numpy as jnp
    from tulip_tpu.config import model_config as jax_model_config
    from tulip_tpu.models import tulip as JT
    from tulip_tpu.train import step as JS
    from tulip_tpu_torch.config import model_config
    from tulip_tpu_torch.models import tulip as TT
    from tulip_tpu_torch.train import step as TS
    from tulip_tpu_torch.utils.checkpoint import (jax_params_from_state_dict,
                                                  state_dict_from_jax)

    jdtype, tdtype = {"bf16": (jnp.bfloat16, torch.bfloat16),
                      "fp32": (jnp.float32, torch.float32)}[dtype]
    batches, lrs = _batches(), _lrs()
    cfg = jax_model_config("tulip_base", **KW)
    params = {k: np.asarray(v) for k, v in
              JT.init_params(jax.random.PRNGKey(0), cfg).items()}

    tx = JS.make_optimizer(WD)
    state = JS.init_train_state({k: jnp.asarray(v) for k, v in
                                 params.items()}, tx)
    jstep = JS.make_train_step(JT.build_model(cfg), tx, compute_dtype=jdtype,
                               donate=False)
    model = TT.TULIP(model_config("tulip_base", **KW))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    step = TS.make_train_step(model, TS.make_optimizer(model, WD),
                              compute_dtype=tdtype)

    jl, tl, moves = [], [], {}
    for i in range(STEPS):
        low, high = batches[i % PER_EPOCH]
        state, (total, _) = jstep(state, jnp.asarray(low), jnp.asarray(high),
                                  np.float32(lrs[i]), jax.random.PRNGKey(i))
        jl.append(float(total))
        total, _ = step(torch.from_numpy(low), torch.from_numpy(high),
                        lrs[i], torch.Generator().manual_seed(i))
        tl.append(float(total))
        if i in ROWS:
            ours = jax_params_from_state_dict(
                {n: p.detach() for n, p in model.named_parameters()})
            moves[i] = max(float(np.abs(ours[k] - np.asarray(v)).max())
                           for k, v in state.params.items()) / LR
    jl, tl = np.asarray(jl), np.asarray(tl)
    first = {"jax": jl[:WINDOW].mean(), "port": tl[:WINDOW].mean()}
    last = {"jax": jl[-WINDOW:].mean(), "port": tl[-WINDOW:].mean()}
    gap = abs(last["port"] - last["jax"]) / last["jax"]

    print(f"\n{dtype}: | step | JAX loss | port loss | (port - JAX) / JAX "
          f"| max abs weight diff / lr |")
    for i in ROWS:
        print(f"| {i} | {jl[i]:.6f} | {tl[i]:.6f} | "
              f"{(tl[i] - jl[i]) / jl[i]:+.3e} | {moves[i]:.3e} |")
    print(f"| last-{WINDOW} mean | {last['jax']:.6f} | {last['port']:.6f} | "
          f"{(last['port'] - last['jax']) / last['jax']:+.3e} | |")
    print(json.dumps(dict(dtype=dtype, jax=jl.tolist(), port=tl.tolist(),
                          weight_diff_over_lr=moves, last_gap=gap)))
    for k in ("jax", "port"):
        assert last[k] < 0.7 * first[k], (k, first[k], last[k])
    assert gap <= 0.15, gap
