#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc compiles tulip_tpu_torch/csrc/*.cu for sm_90a.
3. kernels: every kernel of the main path against its plain PyTorch version
   on the card, at the flagship shapes (TULIP-base, DurLAR 32x2048, batch 2),
   in bf16 (limit 2e-2 of max|ref|) and fp32 (limit 1e-4, TF32 off);
   median kernel and plain times from CUDA events.  Then the three chamfer
   kernels (K5, K6, K7; fp32) on 262,144-point clouds of a synthetic DurLAR
   scan and a perturbed copy, and on a ragged, a uniform and a degenerate
   cloud: each against its plain version and against K7.
4. main path: a synthetic DurLAR folder read by tulip_tpu.data, TULIP-base
   32x2048 -> 128x2048 with random weights from a seeded generator, bf16
   forwards through apply_model at batches 1, 4 and 8; launches per forward,
   finite pred / loss / pixel_loss, forward img/s (median of timed runs).
5. whole model: the batch-1 cuda preds (bf16 and fp32) against the same
   weights run in fp32 on the CPU through the plain versions.
6. eval: the port's evaluate (fp32 and bf16) and MCdrop (50 iterations,
   noise threshold 0.0005, as bash_scripts/tulip_evaluation_durlar.sh) on
   four samples of the phase-4 folder, with the on-device metrics: one K5
   launch per sample, the results files' schema and finite values; the
   same engine with the plain chamfer (chamfer_impl "xla") and with K7
   ("pallas") must agree; the MC full loop must equal its shortcut; K6
   through the metric API (chamfer_distance without pad_to); forward and
   metric ms per sample.
7. training: a synthetic DurLAR train split, TULIP-base 32x2048 ->
   128x2048, bf16 over fp32 master weights, batch 8, drop_path_rate 0.1
   drawn from a device generator, AdamW (lr 5e-4, wd 0.01, warmup-cosine
   LR of bash_scripts/tulip_upsampling_durlar.sh), 20 steps through the
   port's train_one_epoch: finite losses, the launches per step of every
   kernel (K1/K2 none), median step ms, img/s, peak memory; 10 steps on one
   repeated batch, drop-path off, constant LR: the last loss below the
   first; and the whole step at batch 1 (drop-path 0) against the same
   step on the CPU through the plain versions: fp32 loss within 1e-4
   relative and each parameter's gradient within 1e-3 of its max|ref|;
   bf16 loss within 3e-2 and the flattened gradient's cosine >= 0.99.

Phase 3 also holds the training kernels against their plain versions at
the train step's shapes (batch 8): K8 (attention core forward) and K9 (its
backward: dqkv, dbias) at the four stages, shifted and unshifted; K10 (the
two-matmul backward: dx, dlnw, dlnb, dW1, db1, dW2, db2) at the four MLP
widths and the head; K11 (LN + matmul backward: dx, dlnw, dlnb, dW) at the
three merges; every output within the bf16 / fp32 limits of its own
max|ref|.

Then one JSON line with the per-kernel results and, last, the device line
{"ok": true, "device": {...}}.  The card's machine has no JAX: nothing here
imports it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(img_size=(32, 2048), target_img_size=(128, 2048),
                patch_size=(1, 4), window_size=(2, 8), pixel_shuffle=True,
                circular_padding=True, log_transform=True,
                patch_unmerging=True)
# (grid, C, heads) of the four Swin stages at 32x2048
STAGES = [((32, 512), 96, 3), ((16, 256), 192, 6), ((8, 128), 384, 12),
          ((4, 64), 768, 24)]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PER_FORWARD = {"window_msa": 14, "two_matmul": 15, "ln_linear": 3}
PER_STEP = {"window_msa": 0, "attn_core_fwd": 14, "attn_core_bwd": 14,
            "two_matmul": 15, "two_matmul_bwd": 15, "ln_linear": 3,
            "ln_linear_bwd": 3}
TRAIN_BATCH, TRAIN_STEPS = 8, 20
SOURCES = {
    "window_msa": ("tulip_tpu_torch/csrc/window_msa.cu",
                   {"K1": "tulip_tpu/ops/pallas/window_msa.py:476",
                    "K2": "tulip_tpu/ops/pallas/window_msa.py:31"}),
    "two_matmul": ("tulip_tpu_torch/csrc/mlp.cu",
                   {"K3": "tulip_tpu/ops/pallas/mlp.py:28"}),
    "ln_linear": ("tulip_tpu_torch/csrc/mlp.cu",
                  {"K4": "tulip_tpu/ops/pallas/mlp.py:339"}),
    "nn_h2": ("tulip_tpu_torch/csrc/chamfer.cu",
              {"K5": "tulip_tpu/ops/pallas/chamfer_h.py:205"}),
    "nn_h": ("tulip_tpu_torch/csrc/chamfer.cu",
             {"K6": "tulip_tpu/ops/pallas/chamfer_h.py:62"}),
    "nn_brute": ("tulip_tpu_torch/csrc/chamfer.cu",
                 {"K7": "tulip_tpu/ops/pallas/chamfer.py:26"}),
    "attn_core_fwd": ("tulip_tpu_torch/csrc/attn_core.cu",
                      {"K8": "tulip_tpu/ops/pallas/attn_core.py:139"}),
    "attn_core_bwd": ("tulip_tpu_torch/csrc/attn_core.cu",
                      {"K9": "tulip_tpu/ops/pallas/attn_core.py:173"}),
    "two_matmul_bwd": ("tulip_tpu_torch/csrc/mlp_bwd.cu",
                       {"K10": "tulip_tpu/ops/pallas/mlp.py:184"}),
    "ln_linear_bwd": ("tulip_tpu_torch/csrc/mlp_bwd.cu",
                      {"K11": "tulip_tpu/ops/pallas/mlp.py:351"}),
}
TRAIN_KERNELS = ("attn_core_fwd", "attn_core_bwd", "two_matmul_bwd",
                 "ln_linear_bwd")
# chamfer kernels against their plain versions: the kernel fuses two FMAs
# where the plain version rounds each product and sum, <= 2 ulp (1.2e-7
# relative) of each squared distance; the limit leaves room for that
CHAMFER_RTOL, CHAMFER_ATOL = 1e-5, 1e-6
NUM_EVAL = 4


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Median device time of fn() in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rel_err(torch, out, ref):
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def compare(torch, out, ref):
    """({output: err / max|ref|}, max abs err) of one output or a tuple of
    them (the gradients of a backward kernel; None entries skipped)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    errs, abs_err = {}, 0.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        if (o is None) != (r is None):
            raise SystemExit(f"output {i}: kernel {o is None}, plain "
                             f"{r is None}")
        if o is None:
            continue
        if o.shape != r.shape or o.dtype != r.dtype:
            raise SystemExit(f"output {i}: kernel {tuple(o.shape)} {o.dtype}"
                             f", plain {tuple(r.shape)} {r.dtype}")
        errs[i] = rel_err(torch, o, r)
        abs_err = max(abs_err, float((o.float() - r.float()).abs().max()))
    return errs, abs_err


def kernel_cases(torch, device, batch=2, stages=STAGES):
    """(kernel, TPU kernel id, label, kernel_fn, plain_fn, on_path) at the
    main path's shapes (on_path False for a case the forward never runs),
    with inputs drawn from one seeded generator."""
    from tulip_tpu_torch.models import layers as L
    from tulip_tpu_torch.ops import mlp, window_msa as wm

    g = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        for (H, W), C, nh in stages:
            for shifted in (False, True):
                shift = (1, 4) if shifted else (0, 0)
                x = to(rn(batch, H, W, C))
                args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                        to(rn(3 * C, C, scale=C ** -0.5)),
                        to(rn(3 * C, scale=0.1)),
                        to(rn(C, C, scale=C ** -0.5)), to(rn(C, scale=0.1))]
                idx = torch.as_tensor(L.relative_position_index((2, 8)))
                bias = rn(45, nh, scale=0.5)[idx.reshape(-1)]
                bias = bias.reshape(16, 16, nh).permute(2, 0, 1).contiguous()
                mask = (torch.as_tensor(L.shift_attention_mask(
                    (H, W), (2, 8), (1, 4))) if shifted else None)
                bias = bias.to(device)
                mask = None if mask is None else mask.to(device)
                kw = dict(window=(2, 8), shift=shift, eps=1e-6)
                k = "K2" if nh > 8 else "K1"
                label = (f"window_msa {k} {dn} B={batch} grid={H}x{W} C={C} "
                         f"nh={nh} shift={shift}")
                cases.append((
                    "window_msa", k, label,
                    lambda x=x, a=args, b=bias, m=mask, kw=kw:
                        wm.window_msa(x, *a, b, m, **kw),
                    lambda x=x, a=args, b=bias, m=mask, kw=kw:
                        wm.window_msa_ref(x, *a, b, m, **kw), True))
        for (H, W), C, nh in stages:
            N = batch * H * W
            x = to(rn(N, C))
            args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                    to(rn(4 * C, C, scale=C ** -0.5)), to(rn(4 * C, scale=0.1)),
                    to(rn(C, 4 * C, scale=(4 * C) ** -0.5)),
                    to(rn(C, scale=0.1))]
            cases.append((
                "two_matmul", "K3",
                f"two_matmul K3 {dn} mlp N={N} C={C} Hd={4 * C}",
                lambda x=x, a=args: mlp.fused_ln_mlp(x, *a),
                lambda x=x, a=args: mlp.fused_two_matmul_ref(
                    x, *a, act="gelu", residual=True), True))
        # the folded norm_up + ps_head + decoder_pred head (tulip._head)
        N, C = batch * 32 * 512, 96
        rows = torch.arange(C * 16)
        w2 = torch.zeros(16, C * 16)
        w2[rows % 16, rows] = rn(C, scale=C ** -0.5).repeat_interleave(16)
        x = to(rn(N, C))
        args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                to(rn(16 * C, C, scale=C ** -0.5)), to(rn(16 * C, scale=0.1)),
                to(w2), None]
        hk = dict(act="leaky", residual=False)
        cases.append(("two_matmul", "K3",
                      f"two_matmul K3 {dn} head N={N} C={C} Hd={16 * C} O=16",
                      lambda x=x, a=args: mlp.fused_two_matmul(x, *a, **hk),
                      lambda x=x, a=args: mlp.fused_two_matmul_ref(x, *a,
                                                                   **hk),
                      True))
        # the same without the LayerNorm (lnw=None), a path of K3's API
        nln = [None, None] + args[2:]
        cases.append(("two_matmul", "K3",
                      f"two_matmul K3 {dn} no-LN N={N} C={C} Hd={16 * C} O=16",
                      lambda x=x, a=nln: mlp.fused_two_matmul(x, *a, **hk),
                      lambda x=x, a=nln: mlp.fused_two_matmul_ref(x, *a,
                                                                  **hk),
                      False))
        # ragged token counts (N % 16 != 0): the row masking of both kernels
        N, C = 1000, 96
        x = to(rn(N, C))
        args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                to(rn(4 * C, C, scale=C ** -0.5)), to(rn(4 * C, scale=0.1)),
                to(rn(C, 4 * C, scale=(4 * C) ** -0.5)), to(rn(C, scale=0.1))]
        cases.append(("two_matmul", "K3",
                      f"two_matmul K3 {dn} ragged N={N} C={C} Hd={4 * C}",
                      lambda x=x, a=args: mlp.fused_ln_mlp(x, *a),
                      lambda x=x, a=args: mlp.fused_two_matmul_ref(
                          x, *a, act="gelu", residual=True), False))
        merges = [(batch * (H // 2) * (W // 2), 4 * C, True)
                  for (H, W), C, nh in stages[:-1]] + [(1000, 384, False)]
        for N, K, on_path in merges:
            x = to(rn(N, K))
            args = [to(rn(K, scale=0.1, shift=1.0)), to(rn(K, scale=0.1)),
                    to(rn(K // 2, K, scale=K ** -0.5))]
            what = "merge" if on_path else "ragged"
            cases.append(("ln_linear", "K4",
                          f"ln_linear K4 {dn} {what} N={N} K={K} O={K // 2}",
                          lambda x=x, a=args: mlp.fused_ln_linear(x, *a),
                          lambda x=x, a=args: mlp.fused_ln_linear_ref(x, *a),
                          on_path))
    return cases


def kink_guard(torch, x, args, gr, to, rn):
    """Keep the leaky head's check off the kink.  The slope jumps from 0.01
    to 1 at h = 0, and a pre-activation that rounds to opposite sides of 0
    in the kernel and the plain version (another summation order) takes
    another slope: with b1 ~ N(0, 0.1) that alone gave dx 2.3e-2 of
    max|ref| in fp32 on an H100.  So b1 = +-2 (both branches, half the hidden units
    each), W1 at half scale, and the upstream gradient is zeroed on the
    tokens with any |h| < 1e-2 (h in float64 from the rounded inputs; the
    two versions' h differ by < 1e-3 even in bf16).  Edits args[2:4] and
    gr in place; returns a label suffix."""
    from tulip_tpu_torch.models.layers import layer_norm
    lnw, lnb, w1, b1 = args[:4]
    w1.mul_(0.5)
    b1.copy_(to(torch.where(rn(b1.shape[0]) >= 0, 2.0, -2.0)))
    y = layer_norm(x, lnw, lnb, 1e-6).double()
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i in range(0, x.shape[0], 16384):
        h = y[i:i + 16384] @ w1.double().T + b1.double()
        near[i:i + 16384] = (h.abs() < 1e-2).any(1)
    gr[near] = 0
    return f" (g zeroed on {int(near.sum())} tokens near the kink)"


def train_kernel_cases(torch, device, batch=TRAIN_BATCH, stages=STAGES):
    """(kernel, TPU kernel id, label, kernel_fn, plain_fn, on_path) for
    K8-K11 at the train step's shapes; the backward cases return every
    gradient output."""
    from tulip_tpu_torch.models import layers as L
    from tulip_tpu_torch.ops import attn_core as A, mlp

    g = torch.Generator().manual_seed(1)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    idx = torch.as_tensor(L.relative_position_index((2, 8))).reshape(-1)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        for (H, W), C, nh in stages:
            for shifted in (False, True):
                shift = (1, 4) if shifted else (0, 0)
                qkv = to(rn(batch, H, W, 3 * C))
                dout = to(rn(batch, H, W, C))
                bias = rn(45, nh, scale=0.5)[idx].reshape(16, 16, nh)
                bias = bias.permute(2, 0, 1).contiguous().to(device)
                mask = (torch.as_tensor(L.shift_attention_mask(
                    (H, W), (2, 8), (1, 4))).to(device) if shifted else None)
                kw = dict(window=(2, 8), shift=shift)
                what = (f"{dn} B={batch} grid={H}x{W} C={C} nh={nh} "
                        f"shift={shift}")
                a = (qkv, bias, mask)
                cases.append((
                    "attn_core_fwd", "K8", f"attn_core_fwd K8 {what}",
                    lambda a=a, kw=kw: A.attn_core_fwd(*a, **kw),
                    lambda a=a, kw=kw: A.attn_core_ref(*a, **kw), True))
                cases.append((
                    "attn_core_bwd", "K9", f"attn_core_bwd K9 {what}",
                    lambda a=a, d=dout, kw=kw: A.attn_core_bwd(*a, d, **kw),
                    lambda a=a, d=dout, kw=kw: A.attn_core_bwd_ref(*a, d,
                                                                   **kw),
                    True))
        mlps = [(batch * H * W, C, 4 * C, C, "gelu", f"mlp C={C}")
                for (H, W), C, nh in stages]
        mlps.append((batch * 32 * 512, 96, 1536, 16, "leaky", "head C=96"))
        for N, C, Hd, O, act, what in mlps:
            x, gr = to(rn(N, C)), to(rn(N, O))
            args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                    to(rn(Hd, C, scale=C ** -0.5)), to(rn(Hd, scale=0.1)),
                    to(rn(O, Hd, scale=Hd ** -0.5)),
                    to(rn(O, scale=0.1)) if act == "gelu" else None]
            if act == "leaky":
                what += kink_guard(torch, x, args, gr, to, rn)
            kw = dict(act=act, residual=False)
            cases.append((
                "two_matmul_bwd", "K10",
                f"two_matmul_bwd K10 {dn} {what} N={N} Hd={Hd} O={O}",
                lambda x=x, a=args, gr=gr, kw=kw: mlp.two_matmul_bwd(
                    x, *a, gr, **kw),
                lambda x=x, a=args, gr=gr, kw=kw: mlp.two_matmul_bwd_ref(
                    x, *a, gr, **kw), True))
        for (H, W), C, nh in stages[:-1]:
            N, K = batch * (H // 2) * (W // 2), 4 * C
            x, gr = to(rn(N, K)), to(rn(N, K // 2))
            args = [to(rn(K, scale=0.1, shift=1.0)), to(rn(K, scale=0.1)),
                    to(rn(K // 2, K, scale=K ** -0.5))]
            cases.append((
                "ln_linear_bwd", "K11",
                f"ln_linear_bwd K11 {dn} merge N={N} K={K} O={K // 2}",
                lambda x=x, a=args, gr=gr: mlp.ln_linear_bwd(x, *a, gr),
                lambda x=x, a=args, gr=gr: mlp.ln_linear_bwd_ref(x, *a, gr),
                True))
    return cases


def timed_once(torch, fn):
    """(fn(), its device time in ms from CUDA events)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def chamfer_clouds(torch, device):
    """(label, a, b, real rows of b, on_path): a synthetic DurLAR scan and a
    perturbed copy, projected by the port (262,144 points each, the eval
    path's clouds), then clouds the path never gives: a ragged a against a
    sentinel-padded b, uniform clouds and a degenerate all-equal cloud."""
    from tulip_tpu_torch.eval.geometry import img_to_pcd_durlar_torch
    rng = np.random.default_rng(1)
    scan = durlar_scan(rng, 2048)
    pert = np.clip(scan + rng.normal(0, 0.05, scan.shape), 0.5, 119.0)

    def project(img):
        x = torch.from_numpy((img / 120.0).astype(np.float32)).to(device)
        return img_to_pcd_durlar_torch(x)

    gt, pred = project(scan), project(pert)
    P = gt.shape[0]
    n = P - 1000
    sentinels = torch.full((1000, 3), 1e8, device=device)
    uni = torch.from_numpy(rng.uniform(-60, 60, (2, 65536, 3))
                           .astype(np.float32)).to(device)
    same = torch.full((8192, 3), 7.0, device=device)
    return [(f"scan vs perturbed copy N=M={P}", gt, pred, P, True),
            (f"ragged N={n}, b sentinel-padded to {P}", gt[:n].contiguous(),
             torch.cat([pred[:n], sentinels]), n, False),
            ("uniform N=M=65536", uni[0], uni[1], 65536, False),
            ("degenerate all-equal N=M=8192", same, same, 8192, False)]


def chamfer_checks(torch, device):
    """Table rows of K5, K6, K7 against their plain versions and against
    K7, with kernel and plain ms (CUDA events) for the on-path clouds."""
    from tulip_tpu_torch.ops import chamfer as C

    def excess(out, ref):
        """max |out - ref| / (rtol |ref| + atol): <= 1 passes."""
        return float(((out - ref).abs()
                      / (CHAMFER_RTOL * ref.abs() + CHAMFER_ATOL)).max())

    rows = []
    for label, a, b, m_real, on_path in chamfer_clouds(torch, device):
        # K7's chunk on the path is the default 4096 (it has no
        # preferred_chunk); K5 / K6 use their preferred 1024
        c7 = 4096 if on_path else 1024
        pad = (-a.shape[0]) % c7
        a_pad = torch.cat([a, torch.full((pad, 3), 1e8, device=device)])
        ref_a, plain_a_ms = timed_once(
            torch, lambda: C.min_sq_dists_plain(a, b, 1024))
        ref_b, plain_b_ms = timed_once(
            torch, lambda: C._min_sq_dists(b, a, 1024))
        k7 = C.min_sq_dists_brute(a, b, c7)
        k7b = C.min_sq_dists_brute(b, a_pad, c7)[:m_real]
        k6 = C.min_sq_dists_h(a, b, 1024)
        k5a, k5b = C.min_sq_dists_h2(a, b, 1024)
        torch.cuda.synchronize()
        checks = {
            "K7": {"plain": excess(k7, ref_a)},
            "K6": {"plain": excess(k6, ref_a), "K7": excess(k6, k7)},
            "K5": {"plain a->b": excess(k5a, ref_a),
                   "plain b->a": excess(k5b, ref_b),
                   "K7 a->b": excess(k5a, k7),
                   "K7 b->a": excess(k5b[:m_real], k7b)}}
        abs_err = {"K7": float((k7 - ref_a).abs().max()),
                   "K6": float((k6 - ref_a).abs().max()),
                   "K5": max(float((k5a - ref_a).abs().max()),
                             float((k5b - ref_b).abs().max()))}
        times = {"K7": (None, None), "K6": (None, None), "K5": (None, None)}
        if on_path:
            _, plain7 = timed_once(
                torch, lambda: C.min_sq_dists_plain(a, b, c7))
            times = {
                "K7": (cuda_ms(torch, lambda: C.min_sq_dists_brute(a, b, c7),
                               iters=10, warmup=2), plain7),
                "K6": (cuda_ms(torch, lambda: C.min_sq_dists_h(a, b, 1024),
                               iters=10, warmup=2), plain_a_ms),
                "K5": (cuda_ms(torch, lambda: C.min_sq_dists_h2(a, b, 1024),
                               iters=10, warmup=2), plain_a_ms + plain_b_ms)}
        for knum, kernel in (("K7", "nn_brute"), ("K6", "nn_h"),
                             ("K5", "nn_h2")):
            worst = max(checks[knum].values())
            ms, plain_ms = times[knum]
            rows.append(dict(kernel=kernel, knum=knum, dtype="float32",
                             label=f"{kernel} {knum} fp32 {label}",
                             on_path=on_path, checks=checks[knum],
                             max_abs_err=abs_err[knum], ms=ms,
                             plain_ms=plain_ms, ok=worst <= 1.0))
            r = rows[-1]
            t = ("" if ms is None else
                 f" kernel {ms:.3f} ms plain {plain_ms:.1f} ms")
            print(f"kernel {'ok ' if r['ok'] else 'BAD'} {r['label']}: "
                  f"excess over {CHAMFER_RTOL:.0e}|ref|+{CHAMFER_ATOL:.0e} "
                  f"(limit 1) {checks[knum]}, max abs err "
                  f"{abs_err[knum]:.3e}{t}", flush=True)
    return rows


def durlar_scan(rng, width):
    """A synthetic DurLAR range image in metres (128 x width): a range per
    beam plus jitter."""
    base = rng.uniform(5, 100, (128, 1)) * np.ones((1, width))
    return np.clip(base + rng.uniform(-2, 2, (128, width)), 0.5, 119.0)


def write_durlar(root, n, width, split="val"):
    """Synthetic DurLAR split (range + intensity, 128 x width), as a real
    sensor folder holds it: <root>/<split>/<i>.npy."""
    rng = np.random.default_rng(0 if split == "val" else 1)
    d = os.path.join(root, split)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        img = durlar_scan(rng, width)
        arr = np.stack([img.astype(np.float32),
                        rng.uniform(0, 1, (128, width)).astype(np.float32)],
                       -1)
        np.save(os.path.join(d, f"{i:05d}.npy"), arr)


def load_batches(root, batch, width, split="val"):
    from tulip_tpu.data import DataLoader
    from tulip_tpu.data.datasets import build_durlar_upsampling_dataset
    args = types.SimpleNamespace(
        img_size_low_res=[32, width], img_size_high_res=[128, width],
        log_transform=True, roll=False, data_path_low_res=root,
        data_path_high_res=root)
    ds = build_durlar_upsampling_dataset(split == "train", args)
    return list(DataLoader(ds, batch_size=batch, num_workers=2))


def counted():
    """{name: wrapper} of every kernel wrapper with a launch count."""
    from tulip_tpu_torch.ops import attn_core, chamfer, mlp, window_msa as wm
    return {"window_msa": wm.window_msa,
            "two_matmul": mlp.fused_two_matmul,
            "ln_linear": mlp.fused_ln_linear,
            "nn_h2": chamfer.min_sq_dists_h2,
            "nn_h": chamfer.min_sq_dists_h,
            "nn_brute": chamfer.min_sq_dists_brute,
            "attn_core_fwd": attn_core.attn_core_fwd,
            "attn_core_bwd": attn_core.attn_core_bwd,
            "two_matmul_bwd": mlp.two_matmul_bwd,
            "ln_linear_bwd": mlp.ln_linear_bwd}


def counts():
    from tulip_tpu_torch.ops import window_msa as wm
    out = {k: fn.launches for k, fn in counted().items()}
    out["window_msa_many_heads"] = wm.window_msa.launches_many_heads
    return out


def reset_counts():
    from tulip_tpu_torch.ops import window_msa as wm
    for fn in counted().values():
        fn.launches = 0
    wm.window_msa.launches_many_heads = 0


RESULT_KEYS = ["chamfer_dist", "f1", "iou", "mae", "precision", "recall"]


def eval_args(out_dir, **kw):
    """The CLI namespace of bash_scripts/tulip_evaluation_durlar.sh."""
    a = dict(dataset_select="durlar", img_size_low_res=[32, 2048],
             img_size_high_res=[128, 2048], log_transform=True,
             keep_close_scan=False, save_pcd=False, grid_size=0.1,
             num_mcdropout_iterations=50, noise_threshold=0.0005, seed=0,
             output_dir=out_dir)
    a.update(kw)
    return types.SimpleNamespace(**a)


def compare_results(name, x, y, rtol, vox_atol):
    """Per-sample results of two eval runs: mae and chamfer within rtol
    relative, iou / precision / recall / f1 within vox_atol."""
    worst = {}
    for k in RESULT_KEYS:
        a, b = np.asarray(x[k]), np.asarray(y[k])
        d = np.abs(a - b)
        if k in ("mae", "chamfer_dist"):
            d = d / np.abs(b)
        worst[k] = float(d.max())
        if worst[k] > (rtol if k in ("mae", "chamfer_dist") else vox_atol):
            raise SystemExit(f"eval {name}: {k} {x[k]} vs {y[k]}")
    print(f"eval {name}: agree (max rel diff mae {worst['mae']:.2e}, "
          f"chamfer {worst['chamfer_dist']:.2e}, limit {rtol:.0e}; max abs "
          f"diff iou {worst['iou']:.2e}, precision {worst['precision']:.2e},"
          f" recall {worst['recall']:.2e}, limit {vox_atol:.0e})",
          flush=True)
    return worst


def run_eval_phase(torch, dev, data_root, model16, model32):
    """Phase 6: the port's evaluate and MCdrop on NUM_EVAL samples of the
    synthetic DurLAR folder, each run with the counts set to 0 before it
    and read after it."""
    from tulip_tpu_torch.eval import engine as E
    from tulip_tpu_torch.eval.geometry import img_to_pcd_durlar_torch
    from tulip_tpu_torch.eval.metrics import chamfer_distance
    from tulip_tpu_torch.ops import chamfer as C
    from tulip_tpu_torch.utils.writer import TBWriter

    out_dir = os.path.join(REPO, "build", "chip_smoke_eval")
    os.makedirs(out_dir, exist_ok=True)
    samples = load_batches(data_root, 1, 2048)[:NUM_EVAL]
    writer = TBWriter(os.path.join(out_dir, "tb"))
    nn_keys = ("nn_h2", "nn_h", "nn_brute")
    total = {k: 0 for k in nn_keys}
    report = dict(runs={})

    def run(name, engine, model, dtype, nn, forwards, impl="auto",
            data=samples, args=None):
        C.set_default_chamfer_impl(impl)
        reset_counts()
        t0 = time.perf_counter()
        getattr(E, engine)(data, model, writer,
                           args=args or eval_args(out_dir), device=dev,
                           compute_dtype=dtype)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        C.set_default_chamfer_impl("auto")
        fname = "results.txt" if engine == "evaluate" else "results_mcdrop.txt"
        with open(os.path.join(out_dir, fname)) as f:
            res = json.load(f)
        if (sorted(res) != RESULT_KEYS
                or any(len(v) != len(data) for v in res.values())
                or not all(math.isfinite(x) for v in res.values()
                           for x in v)):
            raise SystemExit(f"eval {name}: bad {fname}: {res}")
        got_nn = {k: got[k] for k in nn_keys}
        got_fwd = {k: got[k] for k in PER_FORWARD}
        want_fwd = {k: v * forwards for k, v in PER_FORWARD.items()}
        if got_nn != nn or got_fwd != want_fwd:
            raise SystemExit(f"eval {name}: launches {got}, expected {nn} "
                             f"and {want_fwd}")
        for k in nn_keys:
            total[k] += got[k]
        print(f"eval {name}: {len(data)} samples, {wall / len(data) * 1e3:.1f}"
              f" ms/sample wall, chamfer launches {got_nn}, {fname} "
              f"chamfer_dist {res['chamfer_dist']} mae {res['mae']} iou "
              f"{res['iou']} (random weights: a check that the path runs, "
              f"not a result)", flush=True)
        report["runs"][name] = dict(results=res, launches=got,
                                    ms_per_sample=wall / len(data) * 1e3)
        return res

    k5 = {"nn_h2": NUM_EVAL, "nn_h": 0, "nn_brute": 0}
    f32, b16 = torch.float32, torch.bfloat16
    ev = run("evaluate fp32", "evaluate", model32, f32, k5, NUM_EVAL)
    run("evaluate bf16", "evaluate", model16, b16, k5, NUM_EVAL)
    mc = run("MCdrop fp32", "MCdrop", model32, f32, k5, NUM_EVAL)
    plain = run("evaluate fp32, plain chamfer", "evaluate", model32, f32,
                {k: 0 for k in nn_keys}, NUM_EVAL, impl="xla")
    k7 = run("evaluate fp32, K7", "evaluate", model32, f32,
             {"nn_h2": 0, "nn_h": 0, "nn_brute": 2 * NUM_EVAL}, NUM_EVAL,
             impl="pallas")
    a10 = eval_args(out_dir, num_mcdropout_iterations=10)
    one = {"nn_h2": 1, "nn_h": 0, "nn_brute": 0}
    short = run("MCdrop 10 iterations", "MCdrop", model32, f32, one, 1,
                data=samples[:1], args=a10)
    os.environ["TULIP_TPU_MC_FULL"] = "1"
    full = run("MCdrop 10 iterations, full loop", "MCdrop", model32, f32,
               one, 2, data=samples[:1], args=a10)
    os.environ.pop("TULIP_TPU_MC_FULL")
    # the same clouds and minima: chamfer to rounding of the means,
    # the rest equal
    report["plain_vs_k5"] = compare_results("plain chamfer vs K5", plain, ev,
                                            1e-5, 0.0)
    report["k7_vs_k5"] = compare_results("K7 vs K5", k7, ev, 1e-5, 0.0)
    # the mean of 50 equal passes rounds; voxel edges may flip (1e-3)
    report["mc_vs_eval"] = compare_results("MCdrop vs evaluate", mc, ev,
                                           1e-4, 1e-3)
    # batch 8 against batch 1 forwards: cuBLAS may pick another algorithm
    report["full_vs_shortcut"] = compare_results(
        "MC full loop vs shortcut", full, short, 1e-5, 1e-3)

    # K6 through the metric API (no pad_to), and ms per sample
    fwd32 = E._make_eval_forward(model32, "durlar", True, E._GATES, f32)
    fwd16 = E._make_eval_forward(model16, "durlar", True, E._GATES, b16)
    metrics_fn = E._make_device_metrics("durlar", eval_args(out_dir),
                                        mc=False)
    low = torch.from_numpy(samples[0][0]["sample"]).to(dev)
    high = torch.from_numpy(samples[0][1]["sample"]).to(dev)
    with torch.no_grad():
        outs = fwd32(low, high)
        dm = metrics_fn(*outs[:3])
        pcd_pred = img_to_pcd_durlar_torch(dm["pred_inj"])
        pcd_gt = img_to_pcd_durlar_torch(dm["high_gated"])
        reset_counts()
        cd = chamfer_distance(pcd_gt, pcd_pred)
        got = counts()
        if {k: got[k] for k in nn_keys} != {"nn_h2": 0, "nn_h": 2,
                                             "nn_brute": 0}:
            raise SystemExit(f"chamfer_distance launches {got}")
        total["nn_h"] += got["nn_h"]
        cd5 = float(dm["stats"][1])
        if abs(cd - cd5) > 1e-5 * abs(cd5):
            raise SystemExit(f"chamfer_distance {cd} (K6) vs {cd5} (K5)")
        print(f"eval chamfer_distance (K6 x2) {cd:.6f} vs the K5 stats "
              f"{cd5:.6f}", flush=True)
        ms = dict(forward_fp32=cuda_ms(torch, lambda: fwd32(low, high),
                                       iters=5, warmup=1),
                  forward_bf16=cuda_ms(torch, lambda: fwd16(low, high),
                                       iters=5, warmup=1),
                  metrics_k5=cuda_ms(torch, lambda: metrics_fn(*outs[:3]),
                                     iters=5, warmup=1))
    print(f"eval ms per sample (CUDA events, median of 5): forward fp32 "
          f"{ms['forward_fp32']:.2f}, forward bf16 {ms['forward_bf16']:.2f},"
          f" metrics with K5 {ms['metrics_k5']:.2f}", flush=True)
    report.update(launches=total, ms_per_sample=ms)
    return report


def train_grads(torch, model, x, t, dtype):
    """(loss, {param: fp32 CPU gradient}) of one train-mode forward +
    backward, drop-path off (no generator)."""
    from tulip_tpu_torch.models.tulip import apply_model
    model.zero_grad(set_to_none=True)
    _, loss, _ = apply_model(model, x, t, mode="train", compute_dtype=dtype)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}


def grad_check(torch, got, ref):
    """Loss relative error, {param: err / max|ref|} and the cosine of the
    flattened gradients of two train_grads results."""
    (l_got, g_got), (l_ref, g_ref) = got, ref
    errs = {n: rel_err(torch, g_got[n], g_ref[n]) for n in g_ref}
    a = torch.cat([g_got[n].reshape(-1) for n in g_ref]).double()
    b = torch.cat([g_ref[n].reshape(-1) for n in g_ref]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    return abs(l_got - l_ref) / abs(l_ref), errs, cos


def run_train_phase(torch, dev, data_root, weights):
    """Phase 7: the port's train_one_epoch at the flagship size, with the
    counts set to 0 just before it and read just after; then the
    repeated-batch descent and the whole-step checks (not counted)."""
    from tulip_tpu_torch.models.tulip import tulip_base
    from tulip_tpu_torch.train.engine import train_one_epoch
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step

    width = FLAGSHIP["img_size"][1]
    write_durlar(data_root, 2 * TRAIN_BATCH, width, split="train")
    batches = load_batches(data_root, TRAIN_BATCH, width, split="train")
    loader = batches * (TRAIN_STEPS // len(batches))
    args = types.SimpleNamespace(accum_iter=1, lr=5e-4, min_lr=0.0,
                                 warmup_epochs=60, epochs=600, seed=0,
                                 log_transform=True)

    def fresh(rate, dtype=torch.float32, device=dev):
        m = tulip_base(drop_path_rate=rate, **FLAGSHIP)
        m.load_state_dict(weights, strict=True)
        return m.to(device=device, dtype=dtype)

    model = fresh(0.1)
    step = make_train_step(model, make_optimizer(model, 0.01),
                           compute_dtype=torch.bfloat16)
    times, losses = [], []

    def timed_step(low, high, lr, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(low, high, lr, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(out)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    stats = train_one_epoch(timed_step, loader, 0, device=dev, args=args)
    got = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    if {k: got[k] for k in PER_STEP} != want:
        raise SystemExit(f"train launches {got}, expected {want}")
    vals = [(l.item(), p.item()) for l, p in losses]
    if len(vals) != TRAIN_STEPS or not all(
            math.isfinite(v) for pair in vals for v in pair):
        raise SystemExit(f"train losses {vals}")
    med = statistics.median(times[2:])
    print(f"train: {TRAIN_STEPS} bf16 steps of batch {TRAIN_BATCH} through "
          f"train_one_epoch, drop_path_rate 0.1, launches/step "
          f"{ {k: got[k] // TRAIN_STEPS for k in PER_STEP} }; step median "
          f"{med * 1e3:.2f} ms = {TRAIN_BATCH / med:.2f} img/s (min "
          f"{min(times[2:]) * 1e3:.2f}, max {max(times[2:]) * 1e3:.2f}, "
          f"first {times[0] * 1e3:.1f} ms), peak mem {peak / 2 ** 20:.0f} "
          f"MiB; losses {[round(v[0], 5) for v in vals]} (random weights: "
          f"a check that the path runs, not a result); mean {stats}",
          flush=True)
    report = dict(launches={k: got[k] for k in TRAIN_KERNELS},
                  launches_per_step={k: got[k] // TRAIN_STEPS
                                     for k in PER_STEP},
                  step_ms=[t * 1e3 for t in times], step_ms_median=med * 1e3,
                  img_per_s=TRAIN_BATCH / med, peak_mib=peak / 2 ** 20,
                  losses=vals)

    # one repeated batch, drop-path off, constant LR: the loss falls
    model = fresh(0.1)
    step = make_train_step(model, make_optimizer(model, 0.01),
                           compute_dtype=torch.bfloat16)
    low = torch.from_numpy(batches[0][0]["sample"]).to(dev)
    high = torch.from_numpy(batches[0][1]["sample"]).to(dev)
    rep = [step(low, high, 5e-4, None)[0].item() for _ in range(10)]
    print(f"train: repeated batch, 10 steps at lr 5e-4: loss {rep[0]:.5f} "
          f"-> {rep[-1]:.5f}", flush=True)
    if not rep[-1] < rep[0]:
        raise SystemExit(f"repeated-batch loss did not fall: {rep}")
    report["repeated_batch_losses"] = rep

    # the whole step at batch 1 against the CPU plain path
    x1, t1 = low[:1], high[:1]
    ref = train_grads(torch, fresh(0.0, device=torch.device("cpu")),
                      x1.cpu(), t1.cpu(), torch.float32)
    got32 = train_grads(torch, fresh(0.0), x1, t1, torch.float32)
    got16 = train_grads(torch, fresh(0.0), x1, t1, torch.bfloat16)
    rel32, errs, cos32 = grad_check(torch, got32, ref)
    rel16, _, cos16 = grad_check(torch, got16, ref)
    worst = max(errs, key=errs.get)
    print(f"train whole step batch 1 vs the fp32 cpu plain path: fp32 loss "
          f"{got32[0]:.7f} vs {ref[0]:.7f} (rel {rel32:.2e}, limit 1e-4), "
          f"worst gradient {worst} err/max|ref| {errs[worst]:.2e} (limit "
          f"1e-3), cosine {cos32:.7f}; bf16 loss {got16[0]:.6f} (rel "
          f"{rel16:.2e}, limit 3e-2), gradient cosine {cos16:.5f} (limit "
          f"0.99)", flush=True)
    if not (rel32 <= 1e-4 and errs[worst] <= 1e-3 and rel16 <= 3e-2
            and cos16 >= 0.99):
        raise SystemExit("train whole-step check failed")
    report["whole_step"] = dict(loss_fp32=got32[0], loss_cpu=ref[0],
                                loss_bf16=got16[0], worst_grad=worst,
                                worst_grad_err=errs[worst], cos_fp32=cos32,
                                cos_bf16=cos16)
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tulip_tpu_torch.models.tulip import apply_model, init_params, tulip_base
    from tulip_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi_line)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"name {kind!r} count {torch.cuda.device_count()}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    nvcc_s = build.build_seconds
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s, nvcc "
          f"{'not run (cached)' if nvcc_s is None else f'{nvcc_s:.1f} s'}"
          f" -> {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    # -- 3. kernels vs plain ----------------------------------------------
    table = []
    cases = [c + (20,) for c in kernel_cases(torch, dev)]
    cases += [c + (5,) for c in train_kernel_cases(torch, dev)]
    for kernel, knum, label, kfn, pfn, on_path, iters in cases:
        out = kfn()
        ref = pfn()
        torch.cuda.synchronize()
        errs, abs_err = compare(torch, out, ref)
        err = max(errs.values())
        dn = str((out[0] if isinstance(out, tuple) else out).dtype)
        dn = dn.replace("torch.", "")
        ms = cuda_ms(torch, kfn, iters=iters)
        plain_ms = cuda_ms(torch, pfn, iters=iters)
        ok = err <= TOL[dn]
        table.append(dict(kernel=kernel, knum=knum, label=label, dtype=dn,
                          on_path=on_path, errs=errs,
                          max_abs_err_rel=err, ms=ms, plain_ms=plain_ms,
                          max_abs_err=abs_err, ok=ok))
        each = "" if len(errs) == 1 else f" (outputs {list(errs.values())})"
        print(f"kernel {'ok ' if ok else 'BAD'} {label}: err/max|ref| "
              f"{err:.3e}{each} (limit {TOL[dn]:.0e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms", flush=True)
        del out, ref
    table += chamfer_checks(torch, dev)
    bad = [r["label"] for r in table if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")

    # -- 4. main path ------------------------------------------------------
    data_root = os.path.join(REPO, "build", "chip_smoke_durlar")
    write_durlar(data_root, 8, 2048)
    model = tulip_base(**FLAGSHIP)
    weights = init_params(model.cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(weights, strict=True)
    model = model.to(device=dev, dtype=torch.bfloat16)
    reset_counts()
    throughput, first = {}, {}
    n_forwards = 0
    for bs in (1, 4, 8):
        low, high = load_batches(data_root, bs, 2048)[0]
        x = torch.from_numpy(low["sample"]).to(dev)
        t = torch.from_numpy(high["sample"]).to(dev)
        before = counts()
        pred, loss, pixel_loss = apply_model(model, x, t,
                                             compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        n_forwards += 1
        after = counts()
        delta = {k: after[k] - before[k] for k in PER_FORWARD}
        if delta != PER_FORWARD:
            raise SystemExit(f"launches per forward {delta}, "
                             f"expected {PER_FORWARD}")
        if tuple(pred.shape) != (bs, 1, 128, 2048):
            raise SystemExit(f"pred shape {tuple(pred.shape)}")
        vals = [bool(torch.isfinite(pred).all()), bool(torch.isfinite(loss)),
                bool(torch.isfinite(pixel_loss))]
        if not all(vals):
            raise SystemExit(f"non-finite output at batch {bs}: {vals}")
        first[bs] = (x, pred)
        for _ in range(2):
            apply_model(model, x, t, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            apply_model(model, x, t, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        n_forwards += 12
        med = statistics.median(times)
        throughput[bs] = bs / med
        print(f"main path batch {bs}: pred {tuple(pred.shape)} finite, "
              f"loss {float(loss):.5f} pixel_loss {float(pixel_loss):.5f}, "
              f"launches/forward {delta}, forward median {med * 1e3:.2f} ms "
              f"= {bs / med:.2f} img/s (min {min(times) * 1e3:.2f} ms, "
              f"max {max(times) * 1e3:.2f} ms, peak mem "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.0f} MiB)",
              flush=True)
    launches = counts()
    expect = {k: v * n_forwards for k, v in PER_FORWARD.items()}
    if {k: launches[k] for k in PER_FORWARD} != expect:
        raise SystemExit(f"main-path launches {launches}, expected {expect}")

    # -- 5. whole model vs the plain path on the CPU ------------------------
    x1, pred_bf16 = first[1]
    cpu_model = tulip_base(**FLAGSHIP)
    cpu_model.load_state_dict(weights, strict=True)
    ref = apply_model(cpu_model, x1.cpu(), mc_drop=True)
    err_bf16 = rel_err(torch, pred_bf16.cpu(), ref)
    model32 = tulip_base(**FLAGSHIP).to(dev)
    model32.load_state_dict(weights, strict=True)
    pred_fp32 = apply_model(model32, x1, mc_drop=True)
    err_fp32 = rel_err(torch, pred_fp32.cpu(), ref)
    print(f"whole model batch 1 vs fp32 cpu plain path: bf16 cuda err/max|ref| "
          f"{err_bf16:.3e} (limit 3e-2), fp32 cuda {err_fp32:.3e} "
          f"(limit 1e-3)", flush=True)
    if not (err_bf16 <= 3e-2 and err_fp32 <= 1e-3):
        raise SystemExit("whole-model check failed")

    # -- 6. eval -----------------------------------------------------------
    eval_report = run_eval_phase(torch, dev, data_root, model, model32)

    # -- 7. training -------------------------------------------------------
    del model, model32, cpu_model
    torch.cuda.empty_cache()
    train_report = run_train_phase(torch, dev, data_root, weights)

    # -- summary -----------------------------------------------------------
    kernels = []
    for kernel, (src, knums) in SOURCES.items():
        for knum, replaces in knums.items():
            dtype = "float32" if kernel.startswith("nn_") else "bfloat16"
            rows = [r for r in table if r["knum"] == knum
                    and r["dtype"] == dtype and r["on_path"]]
            n = (eval_report["launches"] if kernel.startswith("nn_")
                 else train_report["launches"] if kernel in TRAIN_KERNELS
                 else launches)[kernel]
            if kernel == "window_msa":
                many = launches["window_msa_many_heads"]
                n = many if knum == "K2" else n - many
            kernels.append(dict(
                name=f"{kernel} ({knum})", route="cuda", source=src,
                replaces=replaces, launches=n,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows)))
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi_line, device=kind, table=table,
                       img_per_s=throughput, kernels=kernels,
                       eval=eval_report, train=train_report,
                       build=dict(seconds=build_s, nvcc_seconds=nvcc_s),
                       whole_model=dict(bf16=err_bf16, fp32=err_fp32)), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
