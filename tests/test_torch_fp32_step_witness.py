"""Why the fp32 whole train step on the card differs from the CPU plain
path by about 1e-4 of a gradient's max, where each kernel differs by
under 1e-6: the relative-position bias tables' gradients are ill
conditioned.  Split TF32 (the fp32 K3's products on the tensor cores)
leaves about 2^-21 of each product, an rms error of about 4e-7 of the
output's rms.  Perturbing every K3 forward output of the plain fp32 step
by that much, as unbiased random noise, moves a bias table's gradient by
tens of times more, relative to its max, than the noise itself; a shrink
of the same size, as a sum that truncates would give, moves it no more.

TULIP-base at 16 x 256 -> 64 x 256, batch 1, seeded weights and scan,
the CPU plain path (plain versions of every kernel)."""

import numpy as np
import pytest
import torch

from tulip_tpu_torch.models.tulip import apply_model, init_params, tulip_base
from tulip_tpu_torch.ops import mlp

SPLIT_TF32_RMS = 4e-7   # rms error / rms output of the fp32 K3 (float64 ref)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _grads(model, x, t):
    model.zero_grad(set_to_none=True)
    _, loss, _ = apply_model(model, x, t, mode="train",
                             compute_dtype=torch.float32)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def _worst(got, ref):
    """(name, err / max|ref|) of the parameter whose gradient moved most."""
    errs = {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max()).item()
            for n in ref if ref[n].abs().max() > 0}
    name = max(errs, key=errs.get)
    return name, errs[name]


@pytest.fixture(scope="module")
def step():
    model = tulip_base(drop_path_rate=0.0, img_size=(16, 256),
                       target_img_size=(64, 256), patch_size=(1, 4),
                       window_size=(2, 8), pixel_shuffle=True,
                       circular_padding=True, log_transform=True,
                       patch_unmerging=True)
    model.load_state_dict(init_params(model.cfg,
                                      torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    rows = rng.uniform(0.05, 0.8, (64, 1)) * np.ones((1, 256))
    hi = np.clip(rows + rng.uniform(-0.02, 0.02, (64, 256)), 0, 1)
    t = torch.from_numpy(hi[None, None].astype(np.float32))
    x = t[:, :, ::4, :].contiguous()
    return model, x, t, _grads(model, x, t)


@pytest.mark.parametrize("kind", ["unbiased", "shrink"])
def test_bias_table_gradient_amplifies_k3_rounding(step, monkeypatch, kind):
    model, x, t, (loss_ref, ref) = step
    plain = mlp.fused_two_matmul_ref
    g = torch.Generator().manual_seed(1)

    def perturbed(*args, **kw):
        out = plain(*args, **kw)
        if kind == "shrink":
            return out * (1 - SPLIT_TF32_RMS / 2)
        r = torch.randint(0, 2, out.shape, generator=g).to(out.dtype) * 2 - 1
        return out * (1 + SPLIT_TF32_RMS * r)

    monkeypatch.setattr(mlp, "fused_two_matmul_ref", perturbed)
    loss, got = _grads(model, x, t)
    name, err = _worst(got, ref)
    print(f"K3 outputs x (1 {'+- ' if kind == 'unbiased' else '- '}"
          f"{SPLIT_TF32_RMS if kind == 'unbiased' else SPLIT_TF32_RMS / 2:.0e}"
          f"): loss moved {abs(loss - loss_ref) / loss_ref:.2e}, worst "
          f"gradient {name} {err:.2e} of its max")
    assert "relative_position_bias_table" in name
    # tens of times the perturbation, and inside the card's 1e-3 limit
    assert 20 * SPLIT_TF32_RMS < err < 1e-3
    assert abs(loss - loss_ref) <= 1e-6 * loss_ref
