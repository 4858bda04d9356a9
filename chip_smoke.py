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
}
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


def write_durlar(root, n, width):
    """Synthetic DurLAR split (range + intensity, 128 x width), as a real
    sensor folder holds it: <root>/val/<i>.npy."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "val")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        img = durlar_scan(rng, width)
        arr = np.stack([img.astype(np.float32),
                        rng.uniform(0, 1, (128, width)).astype(np.float32)],
                       -1)
        np.save(os.path.join(d, f"{i:05d}.npy"), arr)


def load_batches(root, batch, width):
    from tulip_tpu.data import DataLoader
    from tulip_tpu.data.datasets import build_durlar_upsampling_dataset
    args = types.SimpleNamespace(
        img_size_low_res=[32, width], img_size_high_res=[128, width],
        log_transform=True, roll=False, data_path_low_res=root,
        data_path_high_res=root)
    ds = build_durlar_upsampling_dataset(False, args)
    return list(DataLoader(ds, batch_size=batch, num_workers=2))


def counts():
    from tulip_tpu_torch.ops import chamfer, mlp, window_msa as wm
    return {"window_msa": wm.window_msa.launches,
            "window_msa_many_heads": wm.window_msa.launches_many_heads,
            "two_matmul": mlp.fused_two_matmul.launches,
            "ln_linear": mlp.fused_ln_linear.launches,
            "nn_h2": chamfer.min_sq_dists_h2.launches,
            "nn_h": chamfer.min_sq_dists_h.launches,
            "nn_brute": chamfer.min_sq_dists_brute.launches}


def reset_counts():
    from tulip_tpu_torch.ops import chamfer, mlp, window_msa as wm
    wm.window_msa.launches = 0
    wm.window_msa.launches_many_heads = 0
    mlp.fused_two_matmul.launches = 0
    mlp.fused_ln_linear.launches = 0
    chamfer.min_sq_dists_h2.launches = 0
    chamfer.min_sq_dists_h.launches = 0
    chamfer.min_sq_dists_brute.launches = 0


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
    print(f"build: {time.perf_counter() - t0:.1f} s, nvcc "
          f"{'not run (cached)' if nvcc_s is None else f'{nvcc_s:.1f} s'}"
          f" -> {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    sys.stdout.flush()

    # -- 3. kernels vs plain ----------------------------------------------
    table = []
    for kernel, knum, label, kfn, pfn, on_path in kernel_cases(torch, dev):
        out = kfn()
        ref = pfn()
        torch.cuda.synchronize()
        err = rel_err(torch, out, ref)
        dn = str(out.dtype).replace("torch.", "")
        ms, plain_ms = cuda_ms(torch, kfn), cuda_ms(torch, pfn)
        ok = err <= TOL[dn]
        table.append(dict(kernel=kernel, knum=knum, label=label, dtype=dn,
                          on_path=on_path,
                          max_abs_err_rel=err, ms=ms, plain_ms=plain_ms,
                          max_abs_err=float((out.float() - ref.float())
                                            .abs().max()), ok=ok))
        print(f"kernel {'ok ' if ok else 'BAD'} {label}: err/max|ref| "
              f"{err:.3e} (limit {TOL[dn]:.0e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms", flush=True)
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

    # -- summary -----------------------------------------------------------
    kernels = []
    for kernel, (src, knums) in SOURCES.items():
        for knum, replaces in knums.items():
            dtype = "float32" if kernel.startswith("nn_") else "bfloat16"
            rows = [r for r in table if r["knum"] == knum
                    and r["dtype"] == dtype and r["on_path"]]
            n = (eval_report["launches"] if kernel.startswith("nn_")
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
                       eval=eval_report,
                       whole_model=dict(bf16=err_bf16, fp32=err_fp32)), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
