#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc compiles tulip_tpu_torch/csrc/*.cu for sm_90a.
3. kernels: every kernel of the main path against its plain PyTorch version
   on the card, at the flagship shapes (TULIP-base, DurLAR 32x2048, batch 2),
   in bf16 (limit 2e-2 of max|ref|) and fp32 (limit 1e-4, TF32 off);
   median kernel and plain times from CUDA events.
4. main path: a synthetic DurLAR folder read by tulip_tpu.data, TULIP-base
   32x2048 -> 128x2048 with random weights from a seeded generator, bf16
   forwards through apply_model at batches 1, 4 and 8; launches per forward,
   finite pred / loss / pixel_loss, forward img/s (median of timed runs).
5. whole model: the batch-1 cuda preds (bf16 and fp32) against the same
   weights run in fp32 on the CPU through the plain versions.

Then one JSON line with the per-kernel results and, last, the device line
{"ok": true, "device": {...}}.  The card's machine has no JAX: nothing here
imports it.
"""

from __future__ import annotations

import json
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
}


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


def write_durlar(root, n, width):
    """Synthetic DurLAR split (range + intensity, 128 x width), as a real
    sensor folder holds it: <root>/val/<i>.npy."""
    rng = np.random.default_rng(0)
    d = os.path.join(root, "val")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        base = rng.uniform(5, 100, (128, 1)) * np.ones((1, width))
        img = np.clip(base + rng.uniform(-2, 2, (128, width)), 0.5, 119.0)
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
    from tulip_tpu_torch.ops import mlp, window_msa as wm
    return {"window_msa": wm.window_msa.launches,
            "window_msa_many_heads": wm.window_msa.launches_many_heads,
            "two_matmul": mlp.fused_two_matmul.launches,
            "ln_linear": mlp.fused_ln_linear.launches}


def reset_counts():
    from tulip_tpu_torch.ops import mlp, window_msa as wm
    wm.window_msa.launches = 0
    wm.window_msa.launches_many_heads = 0
    mlp.fused_two_matmul.launches = 0
    mlp.fused_ln_linear.launches = 0


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

    # -- summary -----------------------------------------------------------
    kernels = []
    for kernel, (src, knums) in SOURCES.items():
        for knum, replaces in knums.items():
            rows = [r for r in table if r["knum"] == knum
                    and r["dtype"] == "bfloat16" and r["on_path"]]
            n = launches[kernel]
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
                       whole_model=dict(bf16=err_bf16, fp32=err_fp32)), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
