"""Analytic useful-FLOP accounting for the TULIP model.

Counts the matmul FLOPs a perfect implementation must execute per image:
the same integers as tulip_tpu/utils/flops.py for every config.  Elementwise
work (LN, softmax, residuals, pixel shuffles) is bandwidth- not flop-bound
and is excluded.  With a card's dense-bf16 peak this gives TFLOP/s and
model-flop utilization (MFU).
"""

from __future__ import annotations

from ..config import ModelConfig

# Dense bf16 peak TFLOP/s of one card, without sparsity, at its full power
# limit (NVIDIA's data sheets), keyed by a substring of
# torch.cuda.get_device_name().
_PEAK_TFLOPS = {
    "H100 80GB HBM3": 989.0,    # H100 SXM5
    "H100 PCIe": 756.0,
    "H100 NVL": 835.0,
    "H200": 989.0,              # and GH200
    "A100": 312.0,
}


def chip_peak_tflops(device_kind: str | None = None) -> float:
    """Dense-bf16 peak TFLOP/s of the named card, or of CUDA device 0
    (torch.cuda.get_device_name()).  An unknown card raises: pass its peak
    to :func:`mfu` as ``peak_tflops`` instead."""
    if device_kind is None:
        import torch
        device_kind = torch.cuda.get_device_name()
    for key, peak in _PEAK_TFLOPS.items():
        if key.lower() in device_kind.lower():
            return peak
    raise ValueError(f"no dense-bf16 peak known for {device_kind!r}; pass "
                     f"peak_tflops")


def _stage_block_flops(dim: int, grid, window) -> int:
    """One Swin block: qkv + QK^T + PV + proj + MLP(ratio 4)."""
    n = grid[0] * grid[1]
    c = dim
    l = window[0] * window[1]
    qkv = 2 * n * c * 3 * c
    attn = 2 * 2 * n * l * c          # logits + PV, all heads = C dims total
    proj = 2 * n * c * c
    mlp = 2 * 2 * n * c * 4 * c
    return qkv + attn + proj + mlp


def model_forward_flops(cfg: ModelConfig) -> int:
    """Useful matmul FLOPs for ONE forward pass of ONE image."""
    ph, pw = cfg.patch_size
    kw = 8 if cfg.circular_padding else pw
    ho, wo = cfg.img_size[0] // ph, cfg.img_size[1] // pw
    total = 2 * ho * wo * (ph * kw * cfg.in_chans) * cfg.embed_dim

    for i, st in enumerate(cfg.encoder_stages):
        total += st.depth * _stage_block_flops(st.dim, st.grid, st.window)
        if i < cfg.num_layers - 1:
            n = st.grid[0] * st.grid[1]
            total += 2 * (n // 4) * (4 * st.dim) * (2 * st.dim)  # merge

    # first patch expanding at the bottleneck: C -> 2C (conv or linear)
    bot = cfg.encoder_stages[-1]
    nb = bot.grid[0] * bot.grid[1]
    total += 2 * nb * bot.dim * 2 * bot.dim

    for i, st in enumerate(cfg.decoder_stages):
        n = st.grid[0] * st.grid[1]
        total += 2 * n * (2 * st.dim) * st.dim  # skip-connection fuse
        total += st.depth * _stage_block_flops(st.dim, st.grid, st.window)
        if i < cfg.num_layers - 2:
            total += 2 * n * st.dim * 2 * st.dim  # upsample C -> 2C

    last = cfg.decoder_stages[-1]
    n = last.grid[0] * last.grid[1]
    s2 = cfg.upscale_factor ** 2
    c = cfg.embed_dim
    if cfg.pixel_shuffle:
        total += 2 * n * c * c * s2             # ps_head expand conv
    else:
        total += 2 * n * c * s2 * c             # final patch expanding
    total += 2 * n * s2 * c * cfg.in_chans      # decoder_pred 1x1

    return total


def model_train_flops(cfg: ModelConfig) -> int:
    """Useful matmul FLOPs for one train step of one image: every forward
    GEMM has two backward GEMMs (dX and dW) of equal size; optimizer and
    elementwise backward are bandwidth-bound and excluded."""
    return 3 * model_forward_flops(cfg)


def mfu(images_per_sec: float, flops_per_image: int,
        peak_tflops: float | None = None) -> tuple[float, float]:
    """Returns (achieved TFLOP/s, fraction of the card's bf16 peak)."""
    peak = peak_tflops if peak_tflops is not None else chip_peak_tflops()
    tflops = images_per_sec * flops_per_image / 1e12
    return tflops, tflops / peak
