#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tulip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--tree DIR]    (profile_paths: where
        the time goes, in this checkout or in the one at DIR)
    python3 chip_smoke.py --paths [--tree DIR]    (time_paths: the forward's
        and the train step's wall ms, of this checkout or of the one at DIR)
    python3 chip_smoke.py --ranks N    (run_ranks_check: data parallel and
        W-axis sequence parallel over N GPUs under NCCL, on a machine with
        N cards)
    python3 chip_smoke.py --sp    (phase 10 alone)
    python3 chip_smoke.py --variants    (phase 11 alone)
    python3 chip_smoke.py --data    (phase 12 alone)
    python3 chip_smoke.py --classifier    (phase 13 alone)
    python3 chip_smoke.py --ranks N --drift    (the 16-step drift of
        --ranks N part (iv) and of its data-parallel control alone)

Phases, one line or more each; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc compiles tulip_tpu_torch/csrc/*.cu for sm_90a; the bf16
   tensor-core kernels (K3, K4, K10, K11, tn_gemm and the attention
   half-block of K1, K2, K12, K13) must hold HGMMA instructions in their
   SASS, the bf16 training attention core (K8, K9) HMMA (mma.sync), the
   bf16 LayerNorm kernels (K14, K15) 128-bit global loads and stores
   (LDG.E.128 / STG.E.128).
3. kernels: every kernel of the main path against its plain PyTorch version
   on the card, at the flagship shapes (TULIP-base, DurLAR 32x2048, batch 2),
   in bf16 (limit 2e-2 of max|ref|) and fp32 (limit 1e-4, TF32 off);
   median kernel and plain times from CUDA events.  Then the three chamfer
   kernels (K5, K6, K7; fp32) on 262,144-point clouds of a synthetic DurLAR
   scan and a perturbed copy, and on a ragged, a uniform, a degenerate and
   two sentinel-padded clouds (sentinels in a and in b): each against its
   plain version, K5 and K6 against K7 bit for bit (K5 in both directions;
   both over two runs), K5's plan kernels against h2_plan, K6 under
   torch.cuda.set_sync_debug_mode("error") (no host synchronisation, no
   device-to-host copy), and the pair shares K5 and K6 evaluated and an
   exact sweep needs; then K6 and K5 against K7 bit for bit at small and
   ragged shapes (chamfer_edge_cases).
4. main path: a synthetic DurLAR folder read by tulip_tpu_torch.data, TULIP-base
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
   through the metric API (chamfer_distance without pad_to: two K6
   launches, ms per call; given numpy clouds and no device, it sweeps on
   the card: two K6 launches); forward and metric ms per sample; K5 and K6
   checked and timed as in phase 3 on the clouds the metric step gives K5
   (sample 0's gt against the random-weight pred).
7. training: a synthetic DurLAR train split, TULIP-base 32x2048 ->
   128x2048, bf16 over fp32 master weights, batch 8, drop_path_rate 0.1
   drawn from a device generator, AdamW (lr 5e-4, wd 0.01, warmup-cosine
   LR of bash_scripts/tulip_upsampling_durlar.sh), 20 steps through the
   port's train_one_epoch: finite losses, the launches per step of every
   kernel (K1/K2 none), median step ms, img/s, peak memory; the loop's ms
   per step with --pin_mem and with --no_pin_mem; 10 steps on one
   repeated batch, drop-path off, constant LR: the last loss below the
   first; and the whole step at batch 1 (drop-path 0) against the same
   step on the CPU through the plain versions: fp32 loss within 1e-4
   relative and each parameter's gradient within 1e-3 of its max|ref|;
   bf16 loss within 3e-2 and the flattened gradient's cosine >= 0.99.

8. the command line: a synthetic DurLAR folder (16 train, 4 val scans),
   then tulip_tpu_torch.main_lidar_upsampling.main with the flags of
   bash_scripts/tulip_upsampling_durlar.sh (batch 8, bf16, lr 5e-4, wd
   0.01) and TULIP_TPU_LN_PALLAS=1: --epochs 2 (finite train_loss in both
   log.txt lines, both checkpoints, the launches per step of K14, K15, K8,
   K9, K3, K10, K4, K11); an uninterrupted --epochs 3 run and its third
   epoch again from its own checkpoint-1.pth with --resume (prints "With
   optim & sched!", starts at epoch 2, the same loss, weights and moments);
   --eval with --output_dir at the .pth and at the directory (results.txt:
   six keys, four finite values each, one K5 launch per sample) and --eval
   --mc_drop (results_mcdrop.txt); one forward of those weights at batch 2
   with TULIP_TPU_MSA_GROUPED=1 (14 launches of K12) and one with
   TULIP_TPU_MSA_NAT=1 (6 launches of K13), each pred within 2e-2 of the
   default path's max; the module in a process of its own (python3 -m ...
   --epochs 1, exit code 0); and the train step's median ms with and
   without TULIP_TPU_LN_PALLAS=1, and colsum's launches per step in
   both (K15 adds none).

9. data parallel: (a) phase 8's 2-epoch command line again as rank 0 of
   a launcher's world of 1 (RANK=0 WORLD_SIZE=1 LOCAL_RANK=0, a file://
   --dist_url): the group's backend must be nccl, the launches per step
   those of phase 8, and log.txt and checkpoint-1.pth (weights and AdamW
   moments) equal to phase 8's run without a group bit for bit; then the
   step's all_reduce calls (one per gradient bucket), the device ms of the
   batch-8 step with and without the group and of one gradient average
   (torch.profiler), and the step's ms with and without the group (off,
   on, on, off); (b) two gloo ranks, processes of their own on the one
   card (NCCL refuses two ranks on one GPU), batch 4 each, against one
   process at batch 8, drop_path_rate 0.1: fp32 reduced gradients within
   1e-4 of each parameter's max|ref|, the bf16 gradient's cosine >=
   0.999, the two ranks' gradients and, after 3 bf16 steps, weights equal
   bit for bit; their step ms measure host copies, not a multi-GPU system.

10. W-axis sequence parallel (--sp_degree 2): two gloo ranks, processes of
   their own on the one card, each on its W half of the scans
   (run_sp_ranks): (a) the bf16 and fp32 forwards of TULIP-base at full
   width, DurLAR 32x2048 -> 128x2048, batch 1 and 4, the two halves
   joined, against one process on the same weights (bf16 within 3e-2 of
   max|ref|, fp32 1e-4); (b) one fp32 and three bf16 train steps at batch
   4, drop_path_rate 0.1, against one process: fp32 gradients within
   1e-4 of each parameter's max|ref|, the bf16 gradient's cosine >=
   0.999, the ranks' gradients and weights bit-equal; (c) K1 / K2
   launches per forward on each rank 8 / 6, as unsharded, and the train
   kernels' launches a step as one process's; (d) 15 halo exchanges a
   forward, 29 a step, and their transport (gloo moves a CUDA tensor's
   columns through host memory: the times are host-staged exchanges, not
   a multi-GPU time): the bf16 forward's ms at batch 1 and 8 against one
   process, the device ms of the exchanges (there: the staging copies) a
   forward and a step, and of the step; (e) dropout 0.1 / 0.1 (phase
   11(d)'s rates) on the two W shards, each rank keeping its columns of
   the masks one process draws (check_sp_dropout): the fp32 and bf16 "mc"
   forwards at batch 1 and 8 against one process on the same generator
   seeds (1e-4 / 3e-2 of max|ref|; K3 1 and K4 3 launches a forward on
   each rank, the elements drawn one process's), one fp32 and three bf16
   train steps at batch 4 (the limits of (b); K3 / K10 1, K4 / K11 3 a
   step), and three bf16 steps with TULIP_TPU_LN_PALLAS=1 (K14 / K15 14 a
   step on each shard, bf16 limits of (b)); the "mc" forward's ms, the
   draws' device ms at batch 8 and the steps' ms against one process.

11. the model variants (run_variants_phase), full width, DurLAR 32x2048
   -> 128x2048, random weights from seeded generators, each run with the
   counts set to 0 just before it and read just after: (a) Swin-v2 with
   the flagship heads: bf16 forwards at batch 1 and 8 (K1 / K2 / K4 0, K3
   15, K14 31 a forward), the batch-1 bf16 / fp32 preds against the fp32
   CPU plain path (3e-2 / 1e-3 of max|ref|), the batch-8 forward's device
   ms by class and of its cosine attentions alone (torch.profiler), three
   bf16 train steps at batch 8 (K10 15, K15 31 a step; ms, peak memory)
   and the batch-1 whole step against the CPU as phase 7 holds it; (b) v1
   with the default heads (PatchExpanding, FinalPatchExpanding): K1 8, K2
   6, K3 14, K4 3, K14 5 a forward, the batch-1 pred against the CPU; (c)
   TULIP-large with the flags of bash_scripts/tulip_upsampling_carla.sh:
   K1 8, K2 10, K3 19, K4 4 a forward at batch 1 and 8, the batch-1 pred
   against the CPU, three bf16 train steps at batch 8 (K8 / K9 18, K10 19,
   K11 4 a step); (d) dropout 0.1 / 0.1 on the flagship: MCdrop (50
   iterations, threshold 0.0005) on four scans twice (K1 / K2 0 and K3 1
   a forward; the iterations differ, std > 0, the second run draws the
   same and writes the same results_mcdrop.txt), evaluate bit-equal to
   the rate-0 model's, three train steps with finite losses; (e) the
   command line with --swin_v2 and neither head flag: one epoch on phase
   8's folder, then --eval.  Its seconds end the phase.

12. the data path (run_data_phase): (a) seeded synthetic OS1-128 sweeps
   in DurLAR's raw layout (<drive>/ouster_points/data/*.bin, 128 x 2048 x
   4 float32, placed by the beam model from ranges within (0.3, 120) m; 16
   in each of the four train drives, 20 in the test drive) through
   python3 -m tulip_tpu_torch.etl.sample_durlar_dataset with the flags of
   bash_scripts/create_durlar_dataset.sh: 16 train and 2 val files of 128
   x 2048 x 2; (b) the DurLAR builder's folders on them read by the fused
   native reader against the numpy loader + transform chain (bit-equal
   without log1p, within 1e-6 with it), and the port's DataLoader's ms per
   batch of 8 pairs on both paths at --num_workers 2 and 10 (warm page
   cache, the host's CPU count beside them); (c) the command line with the
   flags of bash_scripts/tulip_upsampling_durlar.sh (TULIP-base 32x2048 ->
   128x2048, bf16, batch 8): one epoch on those folders, then --eval on
   the val folder: the launches of the step's and the eval's kernels, the
   native reader's batches counted and no item through the numpy chain,
   finite losses in log.txt, results.txt written, MetricLogger's data time
   against its step time; (d) the flagship's forward and train GFLOP
   (utils/flops.py), chip_peak_tflops() for this card and the MFU of phase
   4's batch-8 forward, utils/profiler.trace around one bf16 forward (its
   trace must name K3's two_matmul_tc_kernel), and device_memory_stats'
   peak.  Its seconds end the phase.

13. the last of the JAX package (run_classifier_phase): (a) the Swin-v2
   image classifier at SwinV2-T width (tulip_tpu_torch.models.
   swin_v2_classifier: 224 x 224, C 96, depths 2 / 2 / 6 / 2, heads 3 / 6
   / 12 / 24, window 7, 1,000 classes), random weights from a seeded
   generator, bf16 forwards at batch 1 and 128 (the reference Swin
   config's eval batch): K3 12 and K14 29 a forward, K1 / K2 / K4 0,
   finite logits, median ms and img/s, peak memory; (b) the batch-1 bf16
   and fp32 logits against the same weights in fp32 on the CPU through
   the plain versions (3e-2 / 1e-3 of max|ref|); (c) K3 (the v2 MLP) and
   K14 at its token counts (batch x 3,136 / 784 / 196 / 49) for batch 1
   and 128, and K3 at the flagship's folded head with two channels (O =
   32), against their plain versions, bf16 twice for the same bits; (d)
   TULIP at the flagship geometry, batch 1, against the CPU: --in_chans 2
   with the pixel-shuffle head and with the default heads (a second,
   seeded channel beside the scan), and a bias-free qkv with v1 blocks:
   its forward (K1 / K2 8 / 6), one bf16 train step (phase 7's launches)
   and the whole step as phase 7 holds it; (e) the batch-128 forward's
   device ms by class (K3, K14, PyTorch's ops) and of its cosine
   attentions alone (torch.profiler).  Its seconds end the phase.

Phase 3 also holds K1 / K2 in bf16 at batch 1 and 8 (the tensor-core
kernel's head splits differ by batch) and at token counts that leave a last
tile of 16, 32 or 48 rows, with shifts that wrap inside one tile; K12 (the
grouped window-major entry, four stages, shifted and not) and K13 (the
natural row-strip entry, the stages with more than 8 heads) at batch 2 and,
in bf16, batch 8; K4 at batch 1 and 8 (the bf16 kernel splits K over CTAs
at batch 1-4), at a ragged token count and at TULIP-large's deepest merge
(K 3,072); every bf16 case of K1, K2, K3, K4, K8, K9, K10, K11, K12, K13
twice for the same bits; and K14 / K15 (LayerNorm forward and backward: y,
dx, dw, db) at the four norm1 shapes of the batch-8 train step, at the
batch-1 step's, at a ragged token count, at TULIP-large's C 1,536 and at
widths whose chunks do not split evenly over a row's lanes, in bf16 and
fp32, against their plain versions (the bf16 cases also twice for the same
bits; K15 one launch and no colsum in bf16; bf16 widths off the plan
refused); beside K14 / K15 it times F.layer_norm and its
backward, beside K8 / K9 F.scaled_dot_product_attention and its backward,
on the same tensors (the library call: a yardstick, used nowhere in the
port).  Every case also gets its bound: the larger of its bytes over 3.35
TB/s and its operations over the H100's peak for the type.  The two
skipping nearest-neighbour searches (K5, K6) are bound by their bytes; the
brute-force one (K7) by the fp32 issue slots of its N x M pairs (7
instructions a pair at 33.5e12 a second).  How many pairs an exact tiled
sweep of the run's clouds cannot skip is printed apart, as the
"nn_needed_pair_share" line, with K5's and K6's work floors (the needed
pairs' instructions at that rate): diagnostics, no part of a bound.

Phase 3 also holds the training kernels against their plain versions at
the train step's shapes (batch 8): K8 (attention core forward) and K9 (its
backward: dqkv, dbias) at the four stages, shifted and unshifted; K10 (the
two-matmul backward: dx, dlnw, dlnb, dW1, db1, dW2, db2) at the four MLP
widths and the head; K11 (LN + matmul backward: dx, dlnw, dlnb, dW) at the
three merges, at a ragged token count and at the batch-1 deepest merge
(dy split over CTAs); in bf16 also K8 / K9 at the batch-1 step's shapes,
on a 2 x 40 grid (5 windows: a short last tile), at C 768 on 15 windows
and at TULIP-large's deepest stage (C 1,536, 48 heads); every output
within the bf16 / fp32 limits of its own max|ref|.  For K8-K11, K14 and
K15 the kernels line also gives the sums per train step (each batch-8
shape's time x its launches in a step).

Then one JSON line with the per-kernel results of all fifteen kernels
(launches on the main paths, error, kernel / plain / library ms, bound) and,
last, the device line
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
    "window_msa_grouped": ("tulip_tpu_torch/csrc/window_msa.cu",
                           {"K12": "tulip_tpu/ops/pallas/window_msa.py:96"}),
    "window_msa_nat": ("tulip_tpu_torch/csrc/window_msa.cu",
                       {"K13": "tulip_tpu/ops/pallas/window_msa.py:531"}),
    "ln_fwd": ("tulip_tpu_torch/csrc/ln.cu",
               {"K14": "tulip_tpu/ops/pallas/ln.py:44"}),
    "ln_bwd": ("tulip_tpu_torch/csrc/ln.cu",
               {"K15": "tulip_tpu/ops/pallas/ln.py:53"}),
}
TRAIN_KERNELS = ("attn_core_fwd", "attn_core_bwd", "two_matmul_bwd",
                 "ln_linear_bwd")
CLI_KERNELS = ("window_msa_grouped", "window_msa_nat", "ln_fwd", "ln_bwd")
# launches per train step of the command line with TULIP_TPU_LN_PALLAS=1
PER_STEP_CLI = dict(PER_STEP, ln_fwd=14, ln_bwd=14)
CLI_BATCH, CLI_TRAIN, CLI_VAL = 8, 16, 4
# the bf16 kernels of K3, K4, K10 and K11 (token passes), the
# weight-gradient product and the attention half-block (K1, K2, K12, K13),
# whose products must be tensor-core instructions (HGMMA in the SASS; the
# half-block's 16 x 16 products are warp-level HMMA, counted beside them)
TENSOR_CORE_KERNELS = ("two_matmul_tc_kernel", "ln_linear_tc_kernel",
                       "mlp_bwd_hidden_kernel", "mlp_bwd_dy_kernel",
                       "ln_linear_bwd_dy_kernel", "tn_gemm_tc_kernel",
                       "window_msa_tc_kernel")
# the bf16 training attention core (K8, K9), whose products must be
# warp-level tensor-core instructions (HMMA: mma.sync)
MMA_SYNC_KERNELS = ("attn_fwd_tc_kernel", "attn_bwd_tc_kernel")
# the bf16 LayerNorm kernels (K14, K15), whose rows must move in 16-byte
# global loads and stores (LDG.E.128 / STG.E.128 in the SASS)
WIDE_ACCESS_KERNELS = ("ln_fwd_reg_kernel", "ln_bwd_reg_kernel")
# fp32 instructions per point pair of a nearest-neighbour sweep: both
# directions (K5: 3 sub, mul, 2 fma, 2 min), one direction (K6, K7: one min)
PAIR_OPS, PAIR_OPS_ONE = 8, 7
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


# published peaks of one H100 SXM: dense bf16 tensor cores, fp32 outside
# them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# fp32 instructions per second outside the tensor cores (an FMA is 2 FLOP)
FP32_ISSUE = PEAK_FLOPS["float32"] / 2


def bound_ms(nbytes, flops, dtype):
    """(least ms the card could take, what binds): the larger of bytes over
    the memory rate (each input read once, each output written once) and
    operations over the peak rate of the type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def issue_bound_ms(nbytes, instructions):
    """bound_ms for fp32 CUDA-core work counted in instructions (an FMA is
    one): the larger of bytes over the memory rate and instructions over
    the fp32 issue rate."""
    return bound_ms(nbytes, instructions * PEAK_FLOPS["float32"] / FP32_ISSUE,
                    "float32")


def work_msa(T, C, nh, n_mask, e):
    """(bytes, flops) of one attention half-block over T tokens: x in, out;
    the four weights; bias and mask tables; qkv + proj products and the two
    16 x 16 x 32 products per head and window."""
    return (2 * T * C * e + (4 * C * C + 6 * C) * e + (nh + n_mask) * 1024,
            T * (8 * C * C + 64 * C))


def work_two_matmul(N, C, Hd, O, e):
    return ((N * C + N * O + Hd * C + Hd + O * Hd + O + 2 * C) * e,
            2 * N * Hd * (C + O))


def work_ln_linear(N, K, O, e):
    return (N * K + N * O + O * K + 2 * K) * e, 2 * N * K * O


def work_attn(T, C, nh, n_mask, e, backward):
    """Attention core: qkv in, out; backward also dout in and dqkv, dbias
    out, and five 16 x 16 x 32 products per head and window for two."""
    tables = (nh + n_mask) * 1024
    if backward:
        return 7 * T * C * e + tables + nh * 1024, 160 * T * C
    return 4 * T * C * e + tables, 64 * T * C


def work_two_matmul_bwd(N, C, Hd, O, e):
    """x, g in; dx out; both weights in; every gradient out in fp32; the
    hidden recomputed, da, dW2, dy, dW1."""
    return ((2 * N * C + N * O + Hd * C + O * Hd) * e
            + (Hd * C + O * Hd + Hd + O + 2 * C) * 4,
            2 * N * Hd * (3 * C + 2 * O))


def work_ln_linear_bwd(N, K, O, e):
    return ((2 * N * K + N * O + O * K) * e + (O * K + 2 * K) * 4,
            4 * N * K * O)


def work_ln(N, C, e, backward):
    if backward:
        return 3 * N * C * e + 12 * C, 14 * N * C
    return 2 * N * C * e + 8 * C, 8 * N * C


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


def msa_inputs(torch, device, to, rn, batch, H, W, C, nh, shifted):
    """(x, [lnw, lnb, wqkv, bqkv, wproj, bproj], bias, mask) of one attention
    half-block on a (batch, H, W, C) grid of 2 x 8 windows, drawn from rn in
    this order; mask is the (1, 4)-shift mask, or None unshifted."""
    from tulip_tpu_torch.models import layers as L
    x = to(rn(batch, H, W, C))
    args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
            to(rn(3 * C, C, scale=C ** -0.5)), to(rn(3 * C, scale=0.1)),
            to(rn(C, C, scale=C ** -0.5)), to(rn(C, scale=0.1))]
    idx = torch.as_tensor(L.relative_position_index((2, 8))).reshape(-1)
    bias = rn(45, nh, scale=0.5)[idx].reshape(16, 16, nh)
    bias = bias.permute(2, 0, 1).contiguous().to(device)
    mask = (torch.as_tensor(L.shift_attention_mask(
        (H, W), (2, 8), (1, 4))).to(device) if shifted else None)
    return x, args, bias, mask


def window_msa_case(torch, device, to, rn, dn, e, batch, H, W, C, nh, shifted,
                    on_path, what=""):
    """One case of the default entry (K1: heads <= 8, K2: more)."""
    from tulip_tpu_torch.ops import window_msa as wm
    x, args, bias, mask = msa_inputs(torch, device, to, rn, batch, H, W, C,
                                     nh, shifted)
    shift = (1, 4) if shifted else (0, 0)
    kw = dict(window=(2, 8), shift=shift, eps=1e-6)
    k = "K2" if nh > 8 else "K1"
    label = (f"window_msa {k} {dn} {what}B={batch} grid={H}x{W} C={C} "
             f"nh={nh} shift={shift}")
    return ("window_msa", k, label,
            lambda: wm.window_msa(x, *args, bias, mask, **kw),
            lambda: wm.window_msa_ref(x, *args, bias, mask, **kw), on_path,
            dict(work=work_msa(batch * H * W, C, nh,
                               0 if mask is None else mask.shape[0], e)))


def more_window_msa_cases(torch, device):
    """K1 / K2 in bf16 beyond batch 2: the batch-1 and batch-8 forwards'
    shapes (the tensor-core kernel's head splits differ by batch), then
    shapes the flagship never gives: last tiles of 16, 32 and 48 tokens (a
    256-wide input's stage 3 is a 4 x 8 or 2 x 8 grid), a tile that ends
    inside an image, and shifts that wrap both axes inside one 64-row
    tile."""
    g = torch.Generator().manual_seed(5)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    to = lambda t: t.to(device=device, dtype=torch.bfloat16)
    cases = [window_msa_case(torch, device, to, rn, "bfloat16", 2, batch, H,
                             W, C, nh, shifted, True)
             for batch in (8, 1) for (H, W), C, nh in STAGES
             for shifted in (False, True)]
    for batch, H, W, C, nh, shifted in (
            (1, 2, 8, 768, 24, False), (1, 4, 8, 768, 24, True),
            (3, 2, 8, 768, 24, False), (5, 2, 8, 96, 3, False),
            (1, 4, 16, 384, 12, True), (2, 4, 32, 192, 6, True)):
        cases.append(window_msa_case(
            torch, device, to, rn, "bfloat16", 2, batch, H, W, C, nh,
            shifted, False, what=f"T%64={batch * H * W % 64} "))
    return cases


def kernel_cases(torch, device, batch=2, stages=STAGES):
    """(kernel, TPU kernel id, label, kernel_fn, plain_fn, on_path, extra)
    at the main path's shapes (on_path False for a case the forward never
    runs), with inputs drawn from one seeded generator.  extra: work =
    (bytes, flops) of the case and, where one PyTorch call computes the
    same function, library = that call."""
    from tulip_tpu_torch.ops import mlp

    g = torch.Generator().manual_seed(0)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        cases += [window_msa_case(torch, device, to, rn, dn, e, batch, H, W,
                                  C, nh, shifted, True)
                  for (H, W), C, nh in stages for shifted in (False, True)]
        cases += two_matmul_cases(to, rn, dn, e, batch, stages)
        x, args = cases[-1][-1]["inputs"]
        N, C = x.shape
        hk = dict(act="leaky", residual=False)
        # the same without the LayerNorm (lnw=None), a path of K3's API
        nln = [None, None] + args[2:]
        cases.append(("two_matmul", "K3",
                      f"two_matmul K3 {dn} no-LN N={N} C={C} Hd={16 * C} O=16",
                      lambda x=x, a=nln: mlp.fused_two_matmul(x, *a, **hk),
                      lambda x=x, a=nln: mlp.fused_two_matmul_ref(x, *a,
                                                                  **hk),
                      False, dict(work=work_two_matmul(N, C, 16 * C, 16, e))))
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
                          x, *a, act="gelu", residual=True), False,
                      dict(work=work_two_matmul(N, C, 4 * C, C, e))))
        cases += ln_linear_cases(to, rn, dn, e, batch, stages)
        cases.append(ln_linear_case(to, rn, dn, e, 1000, 384, "ragged",
                                    False))
    return cases


def ln_linear_case(to, rn, dn, e, N, K, what, on_path):
    """One K4 case: the patch-merging LN + reduction K -> K / 2."""
    from tulip_tpu_torch.ops import mlp
    x = to(rn(N, K))
    args = [to(rn(K, scale=0.1, shift=1.0)), to(rn(K, scale=0.1)),
            to(rn(K // 2, K, scale=K ** -0.5))]
    return ("ln_linear", "K4",
            f"ln_linear K4 {dn} {what} N={N} K={K} O={K // 2}",
            lambda: mlp.fused_ln_linear(x, *args),
            lambda: mlp.fused_ln_linear_ref(x, *args), on_path,
            dict(work=work_ln_linear(N, K, K // 2, e)))


def ln_linear_cases(to, rn, dn, e, batch, stages=STAGES):
    """K4 at the forward's three merges for one batch size and dtype."""
    return [ln_linear_case(to, rn, dn, e, batch * (H // 2) * (W // 2), 4 * C,
                           "merge", True) for (H, W), C, nh in stages[:-1]]


def more_ln_linear_cases(torch, device):
    """K4 beyond batch 2: the batch-8 and batch-1 forwards' merges (at batch
    1-4 the bf16 kernel splits K over CTAs and a second launch adds the
    partial sums) and, off the path, the deepest merge of TULIP-large (a
    2 x 32 grid of 3,072 merged channels per image) at batch 1 and 8."""
    g = torch.Generator().manual_seed(6)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        for batch in (8, 1):
            cases += ln_linear_cases(to, rn, dn, e, batch)
            cases.append(ln_linear_case(to, rn, dn, e, batch * 64, 3072,
                                        "tulip_large merge", False))
    return cases


def two_matmul_cases(to, rn, dn, e, batch, stages=STAGES):
    """K3 at the forward's shapes for one batch size and dtype: the MLP
    half-block of each stage, then the folded norm_up + ps_head +
    decoder_pred head (tulip._head), whose inputs ride along in extra."""
    import torch
    from tulip_tpu_torch.ops import mlp
    cases = []
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
                x, *a, act="gelu", residual=True), True,
            dict(work=work_two_matmul(N, C, 4 * C, C, e))))
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
                  lambda x=x, a=args: mlp.fused_two_matmul_ref(x, *a, **hk),
                  True, dict(work=work_two_matmul(N, C, 16 * C, 16, e),
                             inputs=(x, args))))
    return cases


def more_two_matmul_cases(torch, device):
    """K3 beyond batch 2: the batch-8 shapes (the train step's and the
    batch-8 forward's), batch 1 (stage 3 has 256 tokens: the bf16 kernel
    splits the hidden dimension over CTAs) and token counts that are no
    multiple of the bf16 kernel's 64-row tile, one of them on the split
    path with a streamed LN output."""
    from tulip_tpu_torch.ops import mlp
    g = torch.Generator().manual_seed(3)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        for batch in (8, 1):
            cases += two_matmul_cases(to, rn, dn, e, batch)
        for N, C in ((8229, 192), (77, 384)):
            x = to(rn(N, C))
            args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                    to(rn(4 * C, C, scale=C ** -0.5)),
                    to(rn(4 * C, scale=0.1)),
                    to(rn(C, 4 * C, scale=(4 * C) ** -0.5)),
                    to(rn(C, scale=0.1))]
            cases.append((
                "two_matmul", "K3",
                f"two_matmul K3 {dn} ragged N={N} C={C} Hd={4 * C}",
                lambda x=x, a=args: mlp.fused_ln_mlp(x, *a),
                lambda x=x, a=args: mlp.fused_two_matmul_ref(
                    x, *a, act="gelu", residual=True), False,
                dict(work=work_two_matmul(N, C, 4 * C, C, e))))
    return cases


def check_deterministic(torch, device, cases):
    """K3, K4, K10 and K11 (their token passes, weight-gradient products
    and column sums), the attention half-block through its three entries
    (K1, K2, K12, K13), the training attention core (K8, K9 with its
    d(bias) column sum), the LayerNorm kernels (K14, K15 with dw / db
    summed inside its launch) and tn_gemm on their own: two runs on the
    same inputs must give the same bits (no atomic sums, every cross-block
    sum in a fixed order)."""
    from tulip_tpu_torch.ops import reduce as R
    runs = [(label, kfn) for kernel, _, label, kfn, *_ in cases
            if kernel in ("two_matmul", "two_matmul_bwd", "ln_linear",
                          "ln_linear_bwd", "window_msa",
                          "window_msa_grouped", "window_msa_nat",
                          "attn_core_fwd", "attn_core_bwd", "ln_fwd",
                          "ln_bwd")
            and "bfloat16" in label]
    g = torch.Generator().manual_seed(4)
    for T, M, N in ((131072, 384, 96), (2048, 3072, 768), (1000, 16, 1536)):
        a = torch.randn(T, M, generator=g).to(device, torch.bfloat16)
        b = torch.randn(T, N, generator=g).to(device, torch.bfloat16)
        runs.append((f"tn_gemm bfloat16 T={T} M={M} N={N}",
                     lambda a=a, b=b: R.tn_gemm(a, b)))
    differ = []
    for label, fn in runs:
        one, two = fn(), fn()
        torch.cuda.synchronize()
        one = one if isinstance(one, tuple) else (one,)
        two = two if isinstance(two, tuple) else (two,)
        if not all(torch.equal(p, q) for p, q in zip(one, two)
                   if p is not None):
            differ.append(label)
    print(f"deterministic: {len(runs) - len(differ)} of {len(runs)} bf16 "
          f"K3 / K4 / K10 / K11 / K1 / K2 / K12 / K13 / K8 / K9 / K14 / K15 "
          f"/ tn_gemm cases bit-identical over two runs", flush=True)
    if differ:
        raise SystemExit(f"two runs differ: {differ}")


def sass_counts(build):
    """({kernel: HGMMA instructions}, {kernel: HMMA}, {kernel: (128-bit
    global loads, 128-bit global stores)}) that cuobjdump -sass finds in
    the bf16 tensor-core kernels (TENSOR_CORE_KERNELS, MMA_SYNC_KERNELS)
    and the LayerNorm kernels (WIDE_ACCESS_KERNELS) of the built library,
    every instantiation of a template counted together."""
    import re
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    names = TENSOR_CORE_KERNELS + MMA_SYNC_KERNELS + WIDE_ACCESS_KERNELS
    counts = dict.fromkeys(names, 0)
    warp_level = dict.fromkeys(names, 0)
    wide = {k: [0, 0] for k in names}
    ldg = re.compile(r"\bLDG\.E[\w.]*\.128\b")
    stg = re.compile(r"\bSTG\.E[\w.]*\.128\b")
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line), None)
        elif current and "HGMMA" in line:
            counts[current] += 1
        elif current and "HMMA" in line:
            warp_level[current] += 1
        elif current and ldg.search(line):
            wide[current][0] += 1
        elif current and stg.search(line):
            wide[current][1] += 1
    return (counts, warp_level,
            {k: tuple(wide[k]) for k in WIDE_ACCESS_KERNELS})


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


def attn_core_cases(torch, device, rn, dtype, batch, H, W, C, nh, shifted,
                    on_path, per_step=None, library=True, what=""):
    """K8 and K9 on one (batch, H, W, 3C) grid of 2 x 8 windows, with the
    (1, 4)-shift mask or none, inputs drawn from rn.  The library call beside
    them is F.scaled_dot_product_attention on the same windows, already split
    into q, k, v of (windows, heads, 16, 32), with bias + mask as its
    additive mask, and its backward to q, k, v (not to the bias, which it
    cannot give): timed here, used nowhere in the port.  per_step: launches
    per train step of this shape (the per-step sums of the kernels line)."""
    import torch.nn.functional as F
    from tulip_tpu_torch.models import layers as L
    from tulip_tpu_torch.ops import attn_core as A
    dn = str(dtype).replace("torch.", "")
    to = lambda t: t.to(device=device, dtype=dtype)
    e = 2 if dtype == torch.bfloat16 else 4
    idx = torch.as_tensor(L.relative_position_index((2, 8))).reshape(-1)
    shift = (1, 4) if shifted else (0, 0)
    qkv = to(rn(batch, H, W, 3 * C))
    dout = to(rn(batch, H, W, C))
    bias = rn(45, nh, scale=0.5)[idx].reshape(16, 16, nh)
    bias = bias.permute(2, 0, 1).contiguous().to(device)
    mask = (torch.as_tensor(L.shift_attention_mask(
        (H, W), (2, 8), (1, 4))).to(device) if shifted else None)
    kw = dict(window=(2, 8), shift=shift)
    what = f"{dn} {what}B={batch} grid={H}x{W} C={C} nh={nh} shift={shift}"
    a = (qkv, bias, mask)
    T, n_mask = batch * H * W, 0 if mask is None else mask.shape[0]
    fwd = dict(work=work_attn(T, C, nh, n_mask, e, False), per_step=per_step)
    bwd = dict(work=work_attn(T, C, nh, n_mask, e, True), per_step=per_step)
    if library:
        # the library call's operands: windows split out beforehand
        win = (qkv.reshape(batch, H // 2, 2, W // 8, 8, 3, nh, 32)
               .permute(5, 0, 1, 3, 6, 2, 4, 7)
               .reshape(3, T // 16, nh, 16, 32))
        q, k, v = (t.contiguous().requires_grad_() for t in win)
        add = bias[None]
        if mask is not None:
            add = (add + mask[:, None]).repeat(T // 16 // n_mask, 1, 1, 1)
        add = add.to(dtype).contiguous()
        fwd["library"] = sdpa = lambda q=q, k=k, v=v, add=add: \
            F.scaled_dot_product_attention(q, k, v, attn_mask=add)
        o = sdpa()
        do = torch.randn(o.shape, device=device, dtype=dtype)
        bwd["library"] = lambda o=o, q=q, k=k, v=v, do=do: \
            torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    return [("attn_core_fwd", "K8", f"attn_core_fwd K8 {what}",
             lambda: A.attn_core_fwd(*a, **kw),
             lambda: A.attn_core_ref(*a, **kw), on_path, fwd),
            ("attn_core_bwd", "K9", f"attn_core_bwd K9 {what}",
             lambda: A.attn_core_bwd(*a, dout, **kw),
             lambda: A.attn_core_bwd_ref(*a, dout, **kw), on_path, bwd)]


def more_attn_core_cases(torch, device):
    """K8 / K9 in bf16 beyond the batch-8 step: every stage of the step at
    batch 1 (fewer tiles than CTAs the card holds), then shapes the flagship
    never gives: a 2 x 40 grid (5 windows: a last tile of one window), 15
    windows at C 768 (a last tile of three, eight head groups) and
    TULIP-large's deepest stage (C 1,536, 48 heads, a 2 x 32 grid)."""
    g = torch.Generator().manual_seed(7)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for (H, W), C, nh in STAGES:
        for shifted in (False, True):
            cases += attn_core_cases(torch, device, rn, torch.bfloat16, 1, H,
                                     W, C, nh, shifted, False)
    for batch, H, W, C, nh, shifted in (
            (1, 2, 40, 96, 3, False), (1, 2, 40, 96, 3, True),
            (3, 2, 40, 768, 24, True), (8, 2, 32, 1536, 48, True)):
        cases += attn_core_cases(torch, device, rn, torch.bfloat16, batch, H,
                                 W, C, nh, shifted, False, library=False,
                                 what="off-path ")
    return cases


def train_kernel_cases(torch, device, batch=TRAIN_BATCH, stages=STAGES):
    """(kernel, TPU kernel id, label, kernel_fn, plain_fn, on_path, extra)
    for K8-K11 at the train step's shapes (attn_core_cases for K8 / K9);
    the backward cases return every gradient output.  extra's per_step:
    the launches per train step of the case's shape."""
    from tulip_tpu_torch.ops import mlp

    g = torch.Generator().manual_seed(1)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        for (H, W), C, nh in stages:
            for shifted in (False, True):
                # C < 768: two encoder and two decoder blocks a step, one
                # of each shifted; C 768: the two encoder blocks
                cases += attn_core_cases(torch, device, rn, dtype, batch, H,
                                         W, C, nh, shifted, True,
                                         per_step=1 if C == 768 else 2)
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
                    x, *a, gr, **kw), True,
                dict(work=work_two_matmul_bwd(N, C, Hd, O, e),
                     per_step=1 if act == "leaky" else 2 if C == 768 else 4)))
        # the step's three merges, then off the path a ragged token count
        # and the deepest merge at batch 1 (dy split over CTAs in bf16)
        merges = [(batch * (H // 2) * (W // 2), 4 * C, "merge", True)
                  for (H, W), C, nh in stages[:-1]]
        merges += [(1000, 384, "ragged", False),
                   (256, 1536, "batch-1 merge", False)]
        for N, K, what, on_path in merges:
            x, gr = to(rn(N, K)), to(rn(N, K // 2))
            args = [to(rn(K, scale=0.1, shift=1.0)), to(rn(K, scale=0.1)),
                    to(rn(K // 2, K, scale=K ** -0.5))]
            cases.append((
                "ln_linear_bwd", "K11",
                f"ln_linear_bwd K11 {dn} {what} N={N} K={K} O={K // 2}",
                lambda x=x, a=args, gr=gr: mlp.ln_linear_bwd(x, *a, gr),
                lambda x=x, a=args, gr=gr: mlp.ln_linear_bwd_ref(x, *a, gr),
                on_path, dict(work=work_ln_linear_bwd(N, K, K // 2, e),
                              per_step=1)))
    return cases


def layout_and_ln_cases(torch, device, batch=2, train_batch=TRAIN_BATCH,
                        stages=STAGES, layouts_only=False):
    """(kernel, TPU kernel id, label, kernel_fn, plain_fn, on_path, extra)
    for K12 (grouped window-major MSA, all four stages, shifted and not),
    K13 (natural row-strip MSA, the stages with more than 8 heads) at batch
    2, and K14 / K15 (LayerNorm forward / backward: y; dx, dw, db) at the
    four norm1 shapes of the batch-8 train step, with fp32 w and b as the
    train step holds them.  The library call beside K14 / K15 is
    F.layer_norm and its backward on the same tensors.  layouts_only: the
    bf16 K12 / K13 cases alone, off the path (the layout switches are
    driven at batch 2)."""
    from tulip_tpu_torch.ops import window_msa as wm

    g = torch.Generator().manual_seed(2)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    dtypes = (torch.bfloat16,) + (() if layouts_only else (torch.float32,))
    for dtype in dtypes:
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        for (H, W), C, nh in stages:
            for shifted in (False, True):
                x, args, bias, mask = msa_inputs(torch, device, to, rn, batch,
                                                 H, W, C, nh, shifted)
                work = work_msa(batch * H * W, C, nh,
                                0 if mask is None else mask.shape[0], e)
                what = (f"{dn} B={batch} grid={H}x{W} C={C} nh={nh} "
                        f"{'shifted' if shifted else 'unshifted'}")
                xg = wm.group_partition(x, (2, 8), 8).contiguous()
                cases.append((
                    "window_msa_grouped", "K12",
                    f"window_msa_grouped K12 {what} xg={tuple(xg.shape)}",
                    lambda xg=xg, a=args, b=bias, m=mask:
                        wm.window_msa_grouped(xg, *a, b, m, eps=1e-6),
                    lambda xg=xg, a=args, b=bias, m=mask:
                        wm.window_msa_grouped_ref(xg, *a, b, m, eps=1e-6),
                    not layouts_only, dict(work=work)))
                if nh <= 8:
                    continue
                x4 = x.reshape(batch * (H // 2), 2, W, C)
                cases.append((
                    "window_msa_nat", "K13",
                    f"window_msa_nat K13 {what} x4={tuple(x4.shape)}",
                    lambda x4=x4, a=args, b=bias, m=mask, n=H // 2:
                        wm.window_msa_nat(x4, *a, b, m, nH=n, eps=1e-6),
                    lambda x4=x4, a=args, b=bias, m=mask, n=H // 2:
                        wm.window_msa_nat_ref(x4, *a, b, m, nH=n, eps=1e-6),
                    not layouts_only, dict(work=work)))
        if layouts_only:
            continue
        for (H, W), C, nh in stages:
            cases += ln_cases(torch, device, rn, dtype, train_batch * H * W,
                              C, "", True, per_step=2 if C == 768 else 4)
    return cases


def ln_cases(torch, device, rn, dtype, N, C, what, on_path, per_step=None):
    """The K14 and K15 cases (LayerNorm forward: y; backward: dx, dw, db)
    of one (N, C) token matrix in dtype, with fp32 w and b as the train
    step holds them; the library call beside each is F.layer_norm and its
    backward on the same tensors (weights in dtype)."""
    import torch.nn.functional as F
    from tulip_tpu_torch.ops import ln
    dn = str(dtype).replace("torch.", "")
    to = lambda t: t.to(device=device, dtype=dtype)
    e = 2 if dtype == torch.bfloat16 else 4
    x = to(rn(N, C, scale=2.0, shift=0.5))
    gr = to(rn(N, C))
    w = rn(C, scale=0.1, shift=1.0).to(device)
    b = rn(C, scale=0.1).to(device)
    xl, wl, bl = (to(t).clone().requires_grad_() for t in (x, w, b))
    lib_fwd = lambda: F.layer_norm(xl, (C,), wl, bl, 1e-6)
    yl = lib_fwd()
    lib_bwd = lambda: torch.autograd.grad(yl, (xl, wl, bl), gr,
                                          retain_graph=True)
    label = f"{dn}{what} N={N} C={C}"
    return [
        ("ln_fwd", "K14", f"ln_fwd K14 {label}",
         lambda: ln.ln_fwd(x, w, b, 1e-6),
         lambda: ln.layer_norm_ref(x, w, b, 1e-6), on_path,
         dict(work=work_ln(N, C, e, False), library=lib_fwd,
              per_step=per_step)),
        ("ln_bwd", "K15", f"ln_bwd K15 {label}",
         lambda: ln.ln_bwd(x, w, gr, 1e-6),
         lambda: ln.layer_norm_bwd_ref(x, w, gr, 1e-6), on_path,
         dict(work=work_ln(N, C, e, True), library=lib_bwd,
              per_step=per_step))]


def more_ln_cases(torch, device):
    """K14 / K15 off the batch-8 shapes: the batch-1 step's norm1 shapes,
    a ragged token count (131,067 x 96: the last row group and the last
    CTA's range short), TULIP-large's deepest stage (C 1,536: six 16-byte
    chunks a lane) and widths whose chunks do not split evenly over the
    lanes of a row (C 72, 40), in bf16 and fp32."""
    g = torch.Generator().manual_seed(5)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for (H, W), C, _ in STAGES:
            cases += ln_cases(torch, device, rn, dtype, H * W, C, " batch 1",
                              False)
        for N, C, what in ((131067, 96, " ragged"),
                           (TRAIN_BATCH * 2 * 32, 1536, " large"),
                           (1001, 72, " uneven"), (333, 40, " uneven")):
            cases += ln_cases(torch, device, rn, dtype, N, C, what, False)
    return cases


def check_ln_launches(torch, device):
    """K15 is one launch in bf16 (no colsum) and K14 / K15 refuse bf16
    widths their plan does not take; fp32 keeps the parity kernels and
    their colsum."""
    from tulip_tpu_torch.ops import ln, reduce as R
    g = torch.Generator().manual_seed(8)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, gr = (torch.randn(4096, 192, generator=g).to(device, dtype)
                 for _ in range(2))
        w = torch.randn(192, generator=g).to(device)
        R.colsum.launches = ln.ln_bwd.launches = 0
        ln.ln_bwd(x, w, gr)
        torch.cuda.synchronize()
        got[str(dtype)] = (ln.ln_bwd.launches, R.colsum.launches)
    refused = []
    for fn in (lambda x, w: ln.ln_fwd(x, w, w),
               lambda x, w: ln.ln_bwd(x, w, x)):
        x = torch.randn(64, 100, generator=g).to(device, torch.bfloat16)
        try:
            fn(x, torch.ones(100, device=device))
        except NotImplementedError:
            refused.append(True)
    print(f"ln launches: (K15 calls, colsum launches) of one ln_bwd call "
          f"{got}; bf16 C=100 refused by K14 / K15: {refused}", flush=True)
    if (got["torch.bfloat16"] != (1, 0) or got["torch.float32"][1] < 1
            or refused != [True, True]):
        raise SystemExit("K14 / K15 launch or refusal check failed")


def check_kernel_cases(torch, cases):
    """Run each case's kernel and plain version once and compare, then time
    both (and the library call, where the case has one) with CUDA events.
    Returns the table rows; prints one line per case."""
    table = []
    for kernel, knum, label, kfn, pfn, on_path, extra, iters in cases:
        out = kfn()
        ref = pfn()
        torch.cuda.synchronize()
        errs, abs_err = compare(torch, out, ref)
        err = max(errs.values())
        dn = str((out[0] if isinstance(out, tuple) else out).dtype)
        dn = dn.replace("torch.", "")
        del out, ref
        ms = cuda_ms(torch, kfn, iters=iters)
        plain_ms = cuda_ms(torch, pfn, iters=iters)
        lib = extra.get("library")
        library_ms = None if lib is None else cuda_ms(torch, lib, iters=iters)
        nbytes, flops = extra["work"]
        b_ms, b_by = bound_ms(nbytes, flops, dn)
        ok = err <= TOL[dn]
        table.append(dict(kernel=kernel, knum=knum, label=label, dtype=dn,
                          on_path=on_path, per_step=extra.get("per_step"),
                          errs=errs,
                          max_abs_err_rel=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bytes=nbytes, flops=flops,
                          bound_ms=b_ms, bound_by=b_by,
                          tflops=flops / ms / 1e9,
                          max_abs_err=abs_err, ok=ok))
        each = "" if len(errs) == 1 else f" (outputs {list(errs.values())})"
        libs = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"kernel {'ok ' if ok else 'BAD'} {label}: err/max|ref| "
              f"{err:.3e}{each} (limit {TOL[dn]:.0e}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms{libs} bound {b_ms:.4f} ms ({b_by}) "
              f"achieved {flops / ms / 1e9:.2f} TFLOP/s", flush=True)
    return table


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
    sentinel-padded b, uniform clouds, a degenerate all-equal cloud, and
    sentinels in a (ragged N) and in b, as the callers' P % chunk branch
    pads both: on the scan, and on a grid whose tiles that mix real points
    with sentinels have edges that fp32 rounds by metres at 5e7 m (the
    plan's infinite extent bounds them by 0; tests/test_torch_chamfer.py:
    _sentinel_grid)."""
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
    g = (10 + 0.2 * np.arange(15)).astype(np.float32)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    grid_a = np.concatenate([grid + rng.normal(0, 0.002, grid.shape),
                             np.full((141, 3), 1e8)]).astype(np.float32)
    grid_b = np.concatenate([grid, np.full((4096 - grid.shape[0], 3), 1e8,
                                           np.float32)])
    pad = lambda x, k: torch.cat([x, torch.full((k, 3), 1e8, device=device)])
    return [(f"scan vs perturbed copy N=M={P}", gt, pred, P, True),
            (f"ragged N={n}, b sentinel-padded to {P}", gt[:n].contiguous(),
             torch.cat([pred[:n], sentinels]), n, False),
            ("uniform N=M=65536", uni[0], uni[1], 65536, False),
            ("degenerate all-equal N=M=8192", same, same, 8192, False),
            (f"sentinels in a (N={P - 337}) and b (M={P})",
             pad(gt[:P - 1037], 700), pad(pred[:P - 2000], 2000), P - 2000,
             False),
            (f"grid with sentinels in a (N={grid_a.shape[0]}) and b (M=4096)",
             torch.from_numpy(grid_a).to(device),
             torch.from_numpy(grid_b).to(device), grid.shape[0], False)]


def morton_order(torch, p, lo, hi):
    """Permutation that sorts the points of p along a 30-bit Morton curve
    over the box lo..hi."""
    q = ((p - lo) / (hi - lo).clamp_min(1e-12) * 1023).clamp(0, 1023).long()

    def spread(v):   # 10 bits, two zero bits between neighbours
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return (spread(q[:, 0]) | spread(q[:, 1]) << 1
            | spread(q[:, 2]) << 2).argsort()


def needed_pair_share(torch, a, b, d_a, d_b=None, tile=256, chunk=1024):
    """Share of all point pairs that an exact sweep over Morton-ordered tiles
    of `tile` queries and `chunk` targets has to evaluate: a (tile, chunk)
    pair is needed when the gap between the two bounding boxes is no larger
    than the tile's worst true minimum d_a (or, for both directions, the
    chunk's worst d_b), so that no box bound could skip it.  A diagnostic
    of the clouds: it reads the inputs and the plain version's minima,
    neither a kernel's output nor the tiling a kernel uses."""
    both = torch.cat([a, b])
    lo, hi = both.amin(0), both.amax(0)

    def boxes(p, d, size):
        order = morton_order(torch, p, lo, hi)
        p, d = p[order], d[order]
        pad = (-p.shape[0]) % size
        if pad:
            p = torch.cat([p, p[-1:].expand(pad, 3)])
            d = torch.cat([d, d[-1:].expand(pad)])
        p = p.reshape(-1, size, 3)
        return p.amin(1), p.amax(1), d.reshape(-1, size).amax(1)

    lo_a, hi_a, worst_a = boxes(a, d_a, tile)
    lo_b, hi_b, worst_b = boxes(
        b, d_b if d_b is not None else b.new_zeros(b.shape[0]), chunk)
    gap = torch.maximum(lo_b[None] - hi_a[:, None],
                        lo_a[:, None] - hi_b[None]).clamp_min(0)
    lb = (gap * gap).sum(-1)
    need = lb <= worst_a[:, None]
    if d_b is not None:
        need |= lb <= worst_b[None, :]
    return float(need.float().mean())


def pair_shares(torch, label, a, b, ref_a, ref_b):
    """The "nn_needed_pair_share" line of one cloud pair: the share of all
    point pairs an exact sweep needs over Morton tiles of 256 x 1024 points
    (the tiling of the earlier K5 / K6) and of K5's and K6's own 128 x 32,
    in both directions (K5) and in one (K6), beside the shares K5 and K6
    evaluated in this call (their listed tile pairs per round x 128 x 32),
    and the work floors: the needed pairs at 128 x 32 x PAIR_OPS (K5) or
    PAIR_OPS_ONE (K6) instructions at the fp32 issue rate.  Diagnostics, no
    part of a bound."""
    from tulip_tpu_torch.ops import chamfer as C
    C.min_sq_dists_h2(a, b, 1024)
    listed = C.min_sq_dists_h2.last_counts.tolist()[0::2]
    C.min_sq_dists_h(a, b, 1024)
    listed6 = C.min_sq_dists_h.last_counts.tolist()[0::2]
    N, M = a.shape[0], b.shape[0]
    share = C.H2_ROWS * C.H2_COLS / (N * M)
    need_k5 = needed_pair_share(torch, a, b, ref_a, ref_b, C.H2_ROWS,
                                C.H2_COLS)
    need_k6 = needed_pair_share(torch, a, b, ref_a, None, C.H2_ROWS,
                                C.H2_COLS)
    out = {"clouds": label,
           "one direction (K6), 256 x 1024": needed_pair_share(
               torch, a, b, ref_a),
           "both directions, 256 x 1024": needed_pair_share(
               torch, a, b, ref_a, ref_b),
           "both directions, K5's 128 x 32": need_k5,
           "evaluated by K5 (128 x 32)": sum(listed) * share,
           "evaluated by K5 per round": [n * share for n in listed],
           "work floor ms (needed at 128 x 32)": (
               need_k5 * N * M * PAIR_OPS / FP32_ISSUE * 1e3),
           "one direction, K6's 128 x 32": need_k6,
           "evaluated by K6 (128 x 32)": sum(listed6) * share,
           "evaluated by K6 per round": [n * share for n in listed6],
           "K6 evaluated / needed": sum(listed6) * share / need_k6,
           "K6 work floor ms (needed at 128 x 32)": (
               need_k6 * N * M * PAIR_OPS_ONE / FP32_ISSUE * 1e3),
           "tiling": "Morton order, query x target points per tile"}
    print(json.dumps({"nn_needed_pair_share": out}), flush=True)
    return out


def k5_plan_equal(torch, a, b):
    """K5's plan kernels (Morton codes, one argsort, the sorted clouds and
    tile boxes) against their plain version ops/chamfer.py:h2_plan: the
    same orders and bits."""
    from tulip_tpu_torch.ops import chamfer as C
    N, M = a.shape[0], b.shape[0]
    Ti, Tj, _ = C.h2_sizes(N, M)
    buf = C._h2_buffers(N, M, a.device)
    perm = C._h2_device_plan(a, b, buf)
    pa, pb, a_s, b_s, (ca, ha), (cb, hb) = C.h2_plan(a, b)
    got = buf["boxes"].split([3 * Ti, 3 * Ti, 3 * Tj, 3 * Tj])
    want = (ca, ha, cb, hb)
    return bool(torch.equal(perm[:N], pa) and torch.equal(perm[N:] - N, pb)
                and torch.equal(buf["a_s"].view(N, 3), a_s)
                and torch.equal(buf["b_s"].view(M, 3), b_s)
                and all(torch.equal(g.view(-1, 3), w)
                        for g, w in zip(got, want)))


def chamfer_rows(torch, device, label, a, b, m_real, on_path, timed=("K7",
                 "K6", "K5")):
    """Table rows of K7, K6, K5 on one cloud pair against their plain
    versions (per element CHAMFER_RTOL |ref| + CHAMFER_ATOL) and K5 / K6
    against K7 bit for bit (torch.equal; K5 in both directions, over the
    real rows of b); K5 and K6 twice for the same bits, K5's plan kernels
    against h2_plan (k5_plan_equal), and one K6 call under
    torch.cuda.set_sync_debug_mode("error"), which raises on any
    synchronising call (a device-to-host copy among them).  On the path,
    the kernels in `timed` get kernel and plain ms (CUDA events) and their
    rows; the others are checked and left out of the table."""
    from tulip_tpu_torch.ops import chamfer as C

    def excess(out, ref):
        """max |out - ref| / (rtol |ref| + atol): <= 1 passes."""
        return float(((out - ref).abs()
                      / (CHAMFER_RTOL * ref.abs() + CHAMFER_ATOL)).max())

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
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k6 = C.min_sq_dists_h(a, b, 1024)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k6_again = C.min_sq_dists_h(a, b, 1024)
    k5a, k5b = C.min_sq_dists_h2(a, b, 1024)
    again = C.min_sq_dists_h2(a, b, 1024)
    torch.cuda.synchronize()
    same = {"K7 a->b": bool(torch.equal(k5a, k7)),
            "K7 b->a": bool(torch.equal(k5b[:m_real], k7b)),
            "run twice": bool(torch.equal(k5a, again[0])
                              and torch.equal(k5b, again[1])),
            "plan": k5_plan_equal(torch, a, b)}
    checks = {
        "K7": {"plain": excess(k7, ref_a)},
        "K6": {"plain": excess(k6, ref_a), "K7": excess(k6, k7)},
        "K5": {"plain a->b": excess(k5a, ref_a),
               "plain b->a": excess(k5b, ref_b)}}
    same6 = {"K7": bool(torch.equal(k6, k7)),
             "run twice": bool(torch.equal(k6_again, k7)),
             "no host synchronisation": True}
    equal = {"K7": True, "K6": all(same6.values()), "K5": all(same.values())}
    abs_err = {"K7": float((k7 - ref_a).abs().max()),
               "K6": float((k6 - ref_a).abs().max()),
               "K5": max(float((k5a - ref_a).abs().max()),
                         float((k5b - ref_b).abs().max()))}
    times = {"K7": (None, None), "K6": (None, None), "K5": (None, None)}
    work = {}
    if on_path:
        N, M = a.shape[0], b.shape[0]
        # bytes: both clouds in, the minima out.  Instructions: brute
        # force is all N x M pairs by definition, 7 fp32 instructions
        # each; the two skipping searches need at least one pair per
        # minimum they return, so their bound is the bytes'
        work = {"K7": ((N + M) * 12 + N * 4, N * M * PAIR_OPS_ONE),
                "K6": ((N + M) * 12 + N * 4, N * PAIR_OPS_ONE),
                "K5": ((N + M) * 16, (N + M) * PAIR_OPS)}
        pair_shares(torch, label, a, b, ref_a, ref_b)
        if "K7" in timed:
            _, plain7 = timed_once(
                torch, lambda: C.min_sq_dists_plain(a, b, c7))
            times["K7"] = (cuda_ms(torch, lambda: C.min_sq_dists_brute(
                a, b, c7), iters=10, warmup=2), plain7)
        if "K6" in timed:
            times["K6"] = (cuda_ms(torch, lambda: C.min_sq_dists_h(
                a, b, 1024), iters=10, warmup=2), plain_a_ms)
        times["K5"] = (cuda_ms(torch, lambda: C.min_sq_dists_h2(a, b, 1024),
                               iters=10, warmup=2), plain_a_ms + plain_b_ms)
    rows = []
    for knum, kernel in (("K7", "nn_brute"), ("K6", "nn_h"),
                         ("K5", "nn_h2")):
        worst = max(checks[knum].values())
        ms, plain_ms = times[knum]
        r = dict(kernel=kernel, knum=knum, dtype="float32",
                 label=f"{kernel} {knum} fp32 {label}",
                 on_path=on_path and knum in timed, checks=checks[knum],
                 equal_to_k7={"K5": same, "K6": same6}.get(knum, True),
                 max_abs_err=abs_err[knum], ms=ms, plain_ms=plain_ms,
                 library_ms=None, ok=worst <= 1.0 and equal[knum])
        t = ""
        if ms is not None:
            r["bytes"], r["instructions"] = work[knum]
            r["bound_ms"], r["bound_by"] = issue_bound_ms(*work[knum])
            by = ("fp32 issue slots" if r["bound_by"] == "operations"
                  else r["bound_by"])
            t = (f" kernel {ms:.3f} ms plain {plain_ms:.1f} ms bound "
                 f"{r['bound_ms']:.4f} ms ({by})")
        print(f"kernel {'ok ' if r['ok'] else 'BAD'} {r['label']}: "
              f"excess over {CHAMFER_RTOL:.0e}|ref|+{CHAMFER_ATOL:.0e} "
              f"(limit 1) {checks[knum]}, bit-equal {r['equal_to_k7']}, "
              f"max abs err {abs_err[knum]:.3e}{t}", flush=True)
        if r["on_path"] or not on_path:
            rows.append(r)
    return rows


def chamfer_edge_cases(torch, device):
    """K6 and K5 (a -> b) against K7 bit for bit at the shapes where tiles
    are ragged or few: N of 1, 127, 129 and 3,001 query points (one tile,
    a short last tile), M of 32, 512 and 4,096 targets in chunks of 32 or
    512 (the callers' chunk when P < 1,024), uniform, clustered and
    all-equal clouds, with no sentinels, 1e8 sentinels in b's last third,
    or in a's and b's.  Raises on any difference."""
    import itertools
    from tulip_tpu_torch.ops import chamfer as C
    rng = np.random.default_rng(11)
    centers = rng.uniform(-50, 50, (4, 3))

    def cloud(k, kind):
        if kind == "uniform":
            return rng.uniform(-60, 60, (k, 3)).astype(np.float32)
        if kind == "clustered":
            return (centers[rng.integers(0, 4, k)]
                    + rng.normal(0, 1.5, (k, 3))).astype(np.float32)
        return np.full((k, 3), 7.0, np.float32)

    bad, n = [], 0
    for N, M, chunk, kind, sent in itertools.product(
            (1, 127, 129, 3001), (32, 512, 4096), (32, 512),
            ("uniform", "clustered", "equal"), ("none", "b", "a and b")):
        if M % chunk:
            continue
        a, b = cloud(N, kind), cloud(M, kind)
        if sent != "none":
            b[M - M // 3:] = 1e8
        if sent == "a and b":
            a[N - N // 3:] = 1e8
        ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        k7 = C.min_sq_dists_brute(ta, tb, chunk)
        if not (torch.equal(C.min_sq_dists_h(ta, tb, chunk), k7)
                and torch.equal(C.min_sq_dists_h2(ta, tb, chunk)[0], k7)):
            bad.append((N, M, chunk, kind, sent))
        n += 1
    print(f"chamfer edge cases: K6 and K5 equal to K7 bit for bit in "
          f"{n - len(bad)} of {n} (N 1-3,001, M 32-4,096, chunk 32 / 512, "
          f"sentinels in none, b, a and b)", flush=True)
    if bad:
        raise SystemExit(f"K5 / K6 differ from K7 at {bad}")


def chamfer_checks(torch, device):
    """Table rows of K5, K6, K7 on chamfer_clouds (chamfer_rows), then
    chamfer_edge_cases."""
    rows = []
    for label, a, b, m_real, on_path in chamfer_clouds(torch, device):
        rows += chamfer_rows(torch, device, label, a, b, m_real, on_path)
    chamfer_edge_cases(torch, device)
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
    from tulip_tpu_torch.data import DataLoader
    from tulip_tpu_torch.data.datasets import build_durlar_upsampling_dataset
    args = types.SimpleNamespace(
        img_size_low_res=[32, width], img_size_high_res=[128, width],
        log_transform=True, roll=False, data_path_low_res=root,
        data_path_high_res=root)
    ds = build_durlar_upsampling_dataset(split == "train", args)
    return list(DataLoader(ds, batch_size=batch, num_workers=2))


def counted():
    """{name: wrapper} of every kernel wrapper with a launch count (and
    colsum, the column sum that backward kernels launch after them)."""
    from tulip_tpu_torch.ops import (attn_core, chamfer, ln, mlp,
                                     reduce as R, window_msa as wm)
    return {"window_msa": wm.window_msa,
            "window_msa_grouped": wm.window_msa_grouped,
            "window_msa_nat": wm.window_msa_nat,
            "ln_fwd": ln.ln_fwd,
            "ln_bwd": ln.ln_bwd,
            "two_matmul": mlp.fused_two_matmul,
            "ln_linear": mlp.fused_ln_linear,
            "nn_h2": chamfer.min_sq_dists_h2,
            "nn_h": chamfer.min_sq_dists_h,
            "nn_brute": chamfer.min_sq_dists_brute,
            "attn_core_fwd": attn_core.attn_core_fwd,
            "attn_core_bwd": attn_core.attn_core_bwd,
            "two_matmul_bwd": mlp.two_matmul_bwd,
            "ln_linear_bwd": mlp.ln_linear_bwd,
            "colsum": R.colsum}


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
        # host arrays and no device: the sweep runs on the card too
        reset_counts()
        cd_np = chamfer_distance(pcd_gt.cpu().numpy(),
                                 pcd_pred.cpu().numpy())
        got = counts()
        print(f"eval chamfer_distance of numpy clouds, no device: "
              f"{cd_np:.6f}, K6 launches {got['nn_h']} (want 2)", flush=True)
        if got["nn_h"] != 2 or abs(cd_np - cd) > 1e-6 * abs(cd):
            raise SystemExit("chamfer_distance of host arrays did not sweep "
                             "on the card")
        cd_ms = cuda_ms(torch, lambda: chamfer_distance(pcd_gt, pcd_pred),
                        iters=10, warmup=2)
        print(f"eval chamfer_distance (K6 x2) {cd:.6f} vs the K5 stats "
              f"{cd5:.6f}; {cd_ms:.4f} ms per call (CUDA events, median of "
              f"10: two K6 launches, the padding, the means and the read)",
              flush=True)
        ms = dict(chamfer_distance=cd_ms,
                  forward_fp32=cuda_ms(torch, lambda: fwd32(low, high),
                                       iters=5, warmup=1),
                  forward_bf16=cuda_ms(torch, lambda: fwd16(low, high),
                                       iters=5, warmup=1),
                  metrics_k5=cuda_ms(torch, lambda: metrics_fn(*outs[:3]),
                                     iters=5, warmup=1))
        # K5 and K6 on the clouds the metric step hands K5 (sample 0):
        # timed cases of the path beside phase 3's perturbed copy
        rows = chamfer_rows(
            torch, dev, f"eval path: sample 0 gt vs random-weight pred "
            f"N=M={pcd_gt.shape[0]}", pcd_gt, pcd_pred, pcd_gt.shape[0],
            True, timed=("K5", "K6"))
    print(f"eval ms per sample (CUDA events, median of 5): forward fp32 "
          f"{ms['forward_fp32']:.2f}, forward bf16 {ms['forward_bf16']:.2f},"
          f" metrics with K5 {ms['metrics_k5']:.2f}", flush=True)
    bad = [r["label"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"K5 / K6 on the eval clouds: {bad}")
    report.update(launches=total, ms_per_sample=ms, nn_rows=rows)
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

    # --pin_mem (the default) against --no_pin_mem: the loop from one step's
    # start to the next, which holds the batch's copy to the card
    del model, step
    torch.cuda.empty_cache()
    pin = {True: [], False: []}
    for on in (True, False, False, True):
        pin[on].append(timed_steps(torch, dev, weights, batches, 10, False,
                                   pin_mem=on, whole_loop=True))
    print(f"train loop, batch {TRAIN_BATCH}, bf16, median ms from step start "
          f"to step start of 7 intervals, runs in the order pinned, not, "
          f"not, pinned: --pin_mem {pin[True][0]:.2f} / {pin[True][1]:.2f}, "
          f"--no_pin_mem {pin[False][0]:.2f} / {pin[False][1]:.2f}",
          flush=True)
    report["loop_ms"] = dict(pin_mem=pin[True], no_pin_mem=pin[False])

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


# phase 12: the data path.  DurLAR's raw layout: four train drives and one
# test drive of OS1-128 sweeps (bash_scripts/create_durlar_dataset.sh keeps
# every 4th train and every 10th test scan: 16 train and 2 val files)
ETL_TRAIN_DRIVES = ['DurLAR_20210716', 'DurLAR_20211012', 'DurLAR_20211208',
                    'DurLAR_20210901']
ETL_TEST_DRIVE = 'DurLAR_20211209'
ETL_TRAIN_SCANS, ETL_TEST_SCANS = 16, 20
ETL_COLS = 2048
ETL_FLAGS = ["--output_path_name_train", "train", "--output_path_name_val",
             "val", "--train_data_per_frame", "4", "--test_data_per_frame",
             "10", "--create_val"]
LOADER_BATCH, LOADER_PASSES = 8, 5


def os1_sweep(rng):
    """One synthetic OS1-128 sweep as DurLAR stores it: (128 * 2048, 4)
    float32 x, y, z, intensity in the sensor's staggered order, placed by
    the beam model (eval/geometry.img_to_pcd_durlar) from a range image of
    a range per beam plus jitter, within (0.3, 120) m."""
    from tulip_tpu_torch.eval.geometry import img_to_pcd_durlar
    ranges = durlar_scan(rng, ETL_COLS)
    xyz = img_to_pcd_durlar(ranges / 120.0, maximum_range=120)
    return np.concatenate([xyz, rng.uniform(0, 1, (xyz.shape[0], 1))],
                          axis=1).astype(np.float32)


def numpy_twin(pair):
    """The same folders and transforms without the native spec: every item
    through the numpy loader and transform chain."""
    from tulip_tpu_torch.data.datasets import PairDataset, RangeMapFolder
    return PairDataset(*[RangeMapFolder(d.root, transform=d.transform,
                                        loader=d.loader, class_dir=False)
                         for d in pair.datasets])


def loader_ms(pair, workers):
    """ms per batch of LOADER_BATCH pairs through the port's DataLoader
    (host clock over LOADER_PASSES passes of the folder, the consumer doing
    nothing; median of 3 runs after a warm-up run)."""
    from tulip_tpu_torch.data import DataLoader
    order = list(range(len(pair))) * LOADER_PASSES
    runs = []
    for _ in range(4):
        loader = DataLoader(pair, batch_size=LOADER_BATCH, sampler=order,
                            drop_last=True, num_workers=workers)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        runs.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(runs[1:])


def run_data_phase(torch, dev, weights, img_per_s_b8=None):
    """Phase 12: the data path.  (a) the port's ETL on synthetic raw DurLAR
    drives; (b) the native reader against the numpy chain on its files,
    and both loaders' ms per batch; (c) the command line at full width on
    them, the native counter read; (d) the FLOP / profiler utilities."""
    import re
    import shutil
    from tulip_tpu_torch.data import native
    from tulip_tpu_torch.data.datasets import build_durlar_upsampling_dataset
    from tulip_tpu_torch.models.tulip import apply_model, tulip_base
    from tulip_tpu_torch.utils.flops import (chip_peak_tflops, mfu,
                                             model_forward_flops,
                                             model_train_flops)
    from tulip_tpu_torch.utils.profiler import device_memory_stats, trace
    t_phase = time.perf_counter()
    report = {}
    root = os.path.join(REPO, "build", "chip_smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "DurLAR")

    # -- (a) the ETL ---------------------------------------------------------
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    for drive, n in [(d, ETL_TRAIN_SCANS) for d in ETL_TRAIN_DRIVES] + [
            (ETL_TEST_DRIVE, ETL_TEST_SCANS)]:
        d = os.path.join(raw, drive, "ouster_points", "data")
        os.makedirs(d)
        for i in range(n):
            os1_sweep(rng).tofile(os.path.join(d, f"{i:010d}.bin"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    etl = subprocess.run(
        [sys.executable, "-m", "tulip_tpu_torch.etl.sample_durlar_dataset",
         "--input_path", raw + "/", *ETL_FLAGS],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    etl_s = time.perf_counter() - t0
    if etl.returncode != 0:
        raise SystemExit(f"etl exited {etl.returncode}:\n{etl.stdout}"
                         f"{etl.stderr}")
    made = {s: sorted(os.listdir(os.path.join(raw, s)))
            for s in ("train", "val")}
    arr = np.load(os.path.join(raw, "train", made["train"][0]))
    valid = arr[..., 0][arr[..., 0] > 0]
    ok = (len(made["train"]) == 16 and len(made["val"]) == 2
          and arr.shape == (128, ETL_COLS, 2) and arr.dtype == np.float32
          and float(valid.min()) > 0.3 and float(valid.max()) < 120)
    print(f"data (a) etl: {4 * ETL_TRAIN_SCANS} + {ETL_TEST_SCANS} raw "
          f"sweeps of 128 x {ETL_COLS} x 4 float32 written in {write_s:.1f} "
          f"s; "
          f"python3 -m tulip_tpu_torch.etl.sample_durlar_dataset "
          f"{' '.join(ETL_FLAGS)}: {len(made['train'])} train + "
          f"{len(made['val'])} val files of {arr.shape} {arr.dtype} in "
          f"{etl_s:.1f} s (ranges {float(valid.min()):.3f}-"
          f"{float(valid.max()):.3f} m, {valid.size} of {arr[..., 0].size} "
          f"pixels with a return)", flush=True)
    if not ok:
        raise SystemExit(f"etl output wrong: {made}, {arr.shape}")
    report["etl"] = dict(train=made["train"], val=made["val"],
                         write_s=write_s, etl_s=etl_s)

    # -- (b) the native reader against the numpy chain; both loaders --------
    report["reader"] = {}
    for log in (False, True):
        args = types.SimpleNamespace(
            img_size_low_res=[32, 2048], img_size_high_res=[128, 2048],
            log_transform=log, roll=False, data_path_low_res=raw,
            data_path_high_res=raw)
        pair = build_durlar_upsampling_dataset(True, args)
        if not pair.native:
            raise SystemExit("the ETL's files do not read natively")
        idx = list(range(len(pair)))
        got = pair.read_batch(idx, num_threads=4)
        ref = [np.stack([it["sample"] for it in (d[i] for i in idx)])
               for d in numpy_twin(pair).datasets]
        errs = [float(np.abs(g["sample"] - r).max()) for g, r in zip(got, ref)]
        equal = all(np.array_equal(g["sample"], r) for g, r in zip(got, ref))
        print(f"data (b) native reader vs numpy chain, log1p {log}: "
              f"{len(idx)} pairs, low {got[0]['sample'].shape} high "
              f"{got[1]['sample'].shape}, max |diff| {max(errs):.3e}, "
              f"bit-equal {equal}", flush=True)
        if not (equal if not log else max(errs) <= 1e-6):
            raise SystemExit("the native reader disagrees with the numpy "
                             "chain")
        report["reader"][f"log1p_{log}"] = dict(max_abs_diff=max(errs),
                                                bit_equal=equal)
    report["loader_ms"] = {}
    for name, ds in (("numpy", numpy_twin(pair)), ("native", pair)):
        for workers in (2, 10):
            report["loader_ms"][f"{name}_{workers}"] = loader_ms(ds, workers)
    lm = report["loader_ms"]
    report["cpus"] = os.cpu_count()
    print(f"data (b) loader ms per batch of {LOADER_BATCH} pairs (32 x "
          f"{ETL_COLS} + 128 x {ETL_COLS}, log1p, warm page cache, host clock, "
          f"{os.cpu_count()} CPUs): numpy chain {lm['numpy_2']:.2f} at "
          f"--num_workers 2, {lm['numpy_10']:.2f} at 10; native "
          f"{lm['native_2']:.2f} at 2, {lm['native_10']:.2f} at 10",
          flush=True)

    # -- (c) the command line at full width on the ETL's files --------------
    out = os.path.join(root, "run")
    sched = ["--warmup_epochs", "1", "--save_frequency", "1"]
    native.reset_counts()
    reset_counts()
    text = run_cli_train(cli_flags(raw, out, "--epochs", "1", *sched))
    got, reads = counts(), dict(native.counts)
    steps = len(made["train"]) // CLI_BATCH
    want = {k: v * steps for k, v in PER_STEP.items()}
    log = read_log(out)
    lines = re.findall(r"Epoch: \[0\].*time: ([0-9.]+)\s+data: ([0-9.]+)",
                       text)
    if not lines:
        raise SystemExit(f"no MetricLogger line:\n{text[-3000:]}")
    step_s, data_s = map(float, lines[-1])
    ok = ({k: got[k] for k in want} == want and len(log) == 1
          and math.isfinite(log[0]["train_loss"])
          and reads["batches"] == 2 * steps and reads["numpy_items"] == 0
          and os.path.exists(os.path.join(out, "checkpoint-0.pth")))
    print(f"data (c) cli: one epoch of {steps} bf16 steps of batch "
          f"{CLI_BATCH} on the ETL's folders, launches {got}, train_loss "
          f"{log[0]['train_loss']!r}; native reads {reads}; MetricLogger "
          f"time {step_s * 1e3:.1f} ms / step, data {data_s * 1e3:.1f} ms "
          f"(averages over the epoch's {steps} steps)", flush=True)
    if not ok:
        raise SystemExit(f"data cli training failed: launches {got}, "
                         f"expected {want}; reads {reads}; log {log}")
    native.reset_counts()
    reset_counts()
    text, code = run_cli(cli_flags(raw, out, "--eval", "--noise_threshold",
                                   "0.0005"))
    got, reads = counts(), dict(native.counts)
    with open(os.path.join(out, "results.txt")) as f:
        res = json.load(f)
    n_val = len(made["val"])
    ok = (code == 0 and sorted(res) == RESULT_KEYS
          and all(len(v) == n_val for v in res.values())
          and all(math.isfinite(x) for v in res.values() for x in v)
          and got["nn_h2"] == n_val
          and got["window_msa"] == PER_FORWARD["window_msa"] * n_val
          and reads["batches"] == 2 * n_val and reads["numpy_items"] == 0)
    print(f"data (c) cli --eval: exit {code}, results.txt {n_val} scans, "
          f"K5 launches {got['nn_h2']}, native reads {reads}, mae "
          f"{res['mae']}", flush=True)
    if not ok:
        raise SystemExit(f"data cli --eval failed: exit {code}, launches "
                         f"{got}, reads {reads}, {res}")
    report["cli"] = dict(train_loss=log[0]["train_loss"], results=res,
                         step_ms=step_s * 1e3, data_ms=data_s * 1e3,
                         steps=steps)

    # -- (d) the utilities ---------------------------------------------------
    model = tulip_base(**FLAGSHIP)
    model.load_state_dict(weights, strict=True)
    model = model.to(device=dev, dtype=torch.bfloat16)
    low, high = pair.read_batch(list(range(8)), num_threads=4)
    x = torch.from_numpy(low["sample"]).to(dev)
    t = torch.from_numpy(high["sample"]).to(dev)
    fwd = lambda: apply_model(model, x, t, compute_dtype=torch.bfloat16)
    if img_per_s_b8 is None:   # phase 12 alone: phase 4's protocol here
        for _ in range(3):
            fwd()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        img_per_s_b8 = 8 / statistics.median(times)
    flops = model_forward_flops(model.cfg)
    peak = chip_peak_tflops()
    tflops, share = mfu(img_per_s_b8, flops)
    print(f"data (d) flops: flagship forward {flops / 1e9:.3f} GFLOP, train "
          f"step {model_train_flops(model.cfg) / 1e9:.3f} GFLOP an image; "
          f"chip_peak_tflops() {peak} for "
          f"{torch.cuda.get_device_name(0)!r}; batch-8 bf16 forward "
          f"{img_per_s_b8:.1f} img/s -> {tflops:.2f} TFLOP/s, MFU "
          f"{share * 100:.2f} %", flush=True)
    log_dir = os.path.join(root, "trace")
    torch.cuda.reset_peak_memory_stats(dev)
    with trace(log_dir):
        fwd()
        torch.cuda.synchronize()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(log_dir, files[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k3 = sorted(n for n in names if "two_matmul_tc_kernel" in n)
    mem = device_memory_stats(dev)
    print(f"data (d) profiler: trace of one batch-8 bf16 forward -> "
          f"{files}, {len(names)} event names, K3's kernel "
          f"{k3[0][:60] if k3 else None!r}; device_memory_stats {mem}",
          flush=True)
    if len(files) != 1 or not k3 or not mem.get("peak_bytes_in_use"):
        raise SystemExit("profiler utilities failed")
    report["utils"] = dict(forward_gflop=flops / 1e9,
                           train_gflop=model_train_flops(model.cfg) / 1e9,
                           peak_tflops=peak, img_per_s_b8=img_per_s_b8,
                           tflops=tflops, mfu=share, memory=mem)
    report["seconds"] = time.perf_counter() - t_phase
    print(f"data: phase 12 took {report['seconds']:.1f} s", flush=True)
    return report


def data_only(torch, dev) -> int:
    """``python3 chip_smoke.py --data``: phase 12 alone (the MFU from its
    own batch-8 forwards); no kernel table."""
    from tulip_tpu_torch.models.tulip import init_params, tulip_base
    weights = init_params(tulip_base(**FLAGSHIP).cfg,
                          torch.Generator().manual_seed(0))
    report = run_data_phase(torch, dev, weights)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "data.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


class _Tee:
    """Writes through to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    @property
    def text(self):
        return "".join(self.parts)


def cli_flags(data_root, out_dir, *extra, log_dir=None):
    """The flags of bash_scripts/tulip_upsampling_durlar.sh (and, with
    --eval, of tulip_evaluation_durlar.sh) on a synthetic folder; the
    TensorBoard files go to out_dir, or to log_dir where out_dir names a
    checkpoint file."""
    return ["--batch_size", str(CLI_BATCH), "--num_workers", "2", "--lr",
            "5e-4", "--weight_decay", "0.01", "--model_select", "tulip_base",
            "--pixel_shuffle", "--circular_padding", "--log_transform",
            "--patch_unmerging", "--dataset_select", "durlar",
            "--data_path_low_res", data_root, "--data_path_high_res",
            data_root, "--run_name", "tulip_base", "--wandb_disabled",
            "--output_dir", out_dir, "--log_dir", log_dir or out_dir,
            "--img_size_low_res", "32", "2048", "--img_size_high_res", "128",
            "2048", "--window_size", "2", "8", "--patch_size", "1", "4",
            "--in_chans", "1", *extra]


def run_cli(argv):
    """The port's entry point on argv, in this process, as its ``cli()``
    runs it; returns (stdout text, exit code or None).  The entry point
    patches ``print`` to put a timestamp first: undone here, so that this
    script's own lines stay as they are."""
    import builtins
    from tulip_tpu_torch.config import get_args_parser
    from tulip_tpu_torch.main_lidar_upsampling import main as cli_main
    args = get_args_parser().parse_args(argv)
    if args.output_dir and not args.eval:
        os.makedirs(args.output_dir, exist_ok=True)
    tee, code = _Tee(sys.stdout), None
    saved, sys.stdout = (sys.stdout, builtins.print), tee
    try:
        cli_main(args)
    except SystemExit as e:
        code = e.code
    finally:
        sys.stdout, builtins.print = saved
    return tee.text, code


def run_cli_train(argv):
    """run_cli for a training run, which returns without an exit code (or
    with 0): any other code, such as the abort on a non-finite loss, fails
    the script with the run's output."""
    text, code = run_cli(argv)
    if code not in (None, 0):
        raise SystemExit(f"cli training run exited with {code!r}:\n{text}")
    return text


def read_log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def timed_steps(torch, dev, weights, batches, n_steps, ln_kernels,
                pin_mem=True, whole_loop=False):
    """Median ms of n_steps bf16 train steps of batch TRAIN_BATCH through
    train_one_epoch (the protocol of phase 7: a synchronise around every
    step, the first two steps left out), with or without norm1 through the
    LayerNorm kernels.  whole_loop: the median ms from one step's start to
    the next one's instead, which also holds the loop's host work and the
    batch's copy to the card (pinned first or not: pin_mem)."""
    from tulip_tpu_torch.models.tulip import tulip_base
    from tulip_tpu_torch.train.engine import train_one_epoch
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    if ln_kernels:
        os.environ["TULIP_TPU_LN_PALLAS"] = "1"
    else:
        os.environ.pop("TULIP_TPU_LN_PALLAS", None)
    model = tulip_base(drop_path_rate=0.1, **FLAGSHIP)
    model.load_state_dict(weights, strict=True)
    model = model.to(dev)
    step = make_train_step(model, make_optimizer(model, 0.01),
                           compute_dtype=torch.bfloat16)
    times, starts = [], []

    def timed_step(low, high, lr, generator):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        starts.append(t0)
        out = step(low, high, lr, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    args = types.SimpleNamespace(accum_iter=1, lr=5e-4, min_lr=0.0,
                                 warmup_epochs=60, epochs=600, seed=0,
                                 log_transform=True, pin_mem=pin_mem)
    loader = (batches * n_steps)[:n_steps]
    train_one_epoch(timed_step, loader, 0, device=dev, args=args)
    os.environ.pop("TULIP_TPU_LN_PALLAS", None)
    if whole_loop:
        return statistics.median(np.diff(starts[2:])) * 1e3
    return statistics.median(times[2:]) * 1e3


def run_cli_phase(torch, dev, weights):
    """Phase 8: the command line on the card, through the port's entry
    point; every run has the counts set to 0 just before it and read just
    after."""
    import shutil
    from tulip_tpu_torch.models.tulip import apply_model, tulip_base
    from tulip_tpu_torch.utils.checkpoint import load_checkpoint

    root = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    data_root = os.path.join(root, "durlar")
    write_durlar(data_root, CLI_TRAIN, 2048, split="train")
    write_durlar(data_root, CLI_VAL, 2048, split="val")
    steps_per_epoch = CLI_TRAIN // CLI_BATCH
    report = {}

    def check_train(name, out_dir, text, got, epochs, first_epoch=0):
        n = (epochs - first_epoch) * steps_per_epoch
        want = {k: v * n for k, v in PER_STEP_CLI.items()}
        if {k: got[k] for k in want} != want:
            raise SystemExit(f"cli {name}: launches {got}, expected {want}")
        log = read_log(out_dir)
        if ([e["epoch"] for e in log] != list(range(first_epoch, epochs))
                or not all(math.isfinite(e["train_loss"]) for e in log)):
            raise SystemExit(f"cli {name}: bad log.txt {log}")
        for e in range(first_epoch, epochs):
            if not os.path.exists(os.path.join(out_dir,
                                               f"checkpoint-{e}.pth")):
                raise SystemExit(f"cli {name}: no checkpoint-{e}.pth")
        print(f"cli {name}: {n} steps of batch {CLI_BATCH}, launches/step "
              f"{ {k: got[k] // n for k in want} }, train_loss "
              f"{[e['train_loss'] for e in log]}, checkpoints "
              f"{first_epoch}..{epochs - 1} written", flush=True)
        return log

    # -- train two epochs with norm1 through the LayerNorm kernels ---------
    os.environ["TULIP_TPU_LN_PALLAS"] = "1"
    two = os.path.join(root, "two_epochs")
    sched = ["--warmup_epochs", "1", "--save_frequency", "1"]
    reset_counts()
    text = run_cli_train(cli_flags(data_root, two, "--epochs", "2", *sched))
    got = counts()
    check_train("train --epochs 2", two, text, got, 2)
    report["launches"] = {k: got[k] for k in ("ln_fwd", "ln_bwd")}
    report["launches_per_step"] = {
        k: got[k] // (2 * steps_per_epoch) for k in PER_STEP_CLI}

    # -- an uninterrupted run of three epochs, and its third epoch again
    #    from its own checkpoint-1.pth ------------------------------------
    whole = os.path.join(root, "three_epochs")
    reset_counts()
    text = run_cli_train(cli_flags(data_root, whole, "--epochs", "3", *sched))
    log_whole = check_train("train --epochs 3", whole, text, counts(), 3)
    resumed = os.path.join(root, "resumed")
    reset_counts()
    text = run_cli_train(cli_flags(
        data_root, resumed, "--epochs", "3", *sched, "--resume",
        os.path.join(whole, "checkpoint-1.pth")))
    log_res = check_train("resume --epochs 3", resumed, text, counts(), 3,
                          first_epoch=2)
    if ("With optim & sched!" not in text or "Epoch: [2]" not in text
            or "Epoch: [1]" in text):
        raise SystemExit("cli resume: did not restore the optimizer and "
                         "start at epoch 2")
    a = torch.load(os.path.join(whole, "checkpoint-2.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "checkpoint-2.pth"),
                   weights_only=True)
    diff = max(float((a["model"][k] - b["model"][k]).abs().max())
               for k in a["model"])
    mom = max(float((s["exp_avg"] - b["optimizer"]["state"][k]["exp_avg"])
                    .abs().max())
              for k, s in a["optimizer"]["state"].items())
    loss_a, loss_b = log_whole[2]["train_loss"], log_res[0]["train_loss"]
    print(f"cli resume: prints 'With optim & sched!', starts at epoch 2; "
          f"epoch-2 train_loss {loss_b!r} vs uninterrupted {loss_a!r}; max "
          f"|weight diff| {diff:.3e}, max |exp_avg diff| {mom:.3e} (bitwise "
          f"equal: {diff == 0.0 and mom == 0.0 and loss_a == loss_b})",
          flush=True)
    # every kernel of the step sums in a fixed order, so the bits should
    # agree; the limit below is what a run with restored state must meet
    # even if a library kernel should sum in another order (a resume that
    # lost the moments moves each weight by about lr = 5e-4 instead)
    if not (diff <= 1e-6 and mom <= 1e-6
            and abs(loss_a - loss_b) <= 1e-5 * abs(loss_a)):
        raise SystemExit("cli resume does not reproduce the uninterrupted "
                         "run")
    report["resume"] = dict(loss=loss_b, loss_uninterrupted=loss_a,
                            max_weight_diff=diff, max_exp_avg_diff=mom)
    os.environ.pop("TULIP_TPU_LN_PALLAS")

    # -- eval from the .pth and from the directory, then MC dropout --------
    def check_eval(name, argv, fname):
        out = os.path.join(two, fname)
        if os.path.exists(out):
            os.remove(out)
        reset_counts()
        text, code = run_cli(argv)
        got = counts()
        with open(out) as f:
            res = json.load(f)
        ok = (code == 0 and sorted(res) == RESULT_KEYS
              and all(len(v) == CLI_VAL for v in res.values())
              and all(math.isfinite(x) for v in res.values() for x in v)
              and got["nn_h2"] == CLI_VAL
              and got["window_msa"] == PER_FORWARD["window_msa"] * CLI_VAL)
        print(f"cli {name}: exit {code}, {fname} {len(res['mae'])} samples, "
              f"K5 launches {got['nn_h2']}, mae {res['mae']}", flush=True)
        if not ok:
            raise SystemExit(f"cli {name}: exit {code}, launches {got}, "
                             f"{fname}: {res}")
        return text

    ev = ["--eval", "--noise_threshold", "0.0005"]
    ckpt1 = os.path.join(two, "checkpoint-1.pth")
    t1 = check_eval("--eval at the .pth",
                    cli_flags(data_root, ckpt1, *ev, log_dir=two),
                    "results.txt")
    t2 = check_eval("--eval at the directory",
                    cli_flags(data_root, two, *ev), "results.txt")
    if (f"Resume checkpoint {ckpt1}" not in t1
            or f"Resume checkpoint {ckpt1}" not in t2):
        raise SystemExit("cli --eval: checkpoint-1.pth was not the one read")
    check_eval("--eval --mc_drop",
               cli_flags(data_root, ckpt1, *ev, "--mc_drop", log_dir=two),
               "results_mcdrop.txt")

    # -- the two other attention layouts on the trained weights ------------
    model = tulip_base(**FLAGSHIP)
    model.load_state_dict(load_checkpoint(ckpt1)["model"], strict=True)
    model = model.to(device=dev, dtype=torch.bfloat16)
    low, _ = load_batches(data_root, 2, 2048)[0]
    x = torch.from_numpy(low["sample"]).to(dev)
    fwd = lambda: apply_model(model, x, mc_drop=True,
                              compute_dtype=torch.bfloat16)
    ref = fwd()
    report["layouts"] = {}
    for flag, kernel, want in (
            ("TULIP_TPU_MSA_GROUPED", "window_msa_grouped",
             dict(window_msa_grouped=14, window_msa_nat=0, window_msa=0)),
            ("TULIP_TPU_MSA_NAT", "window_msa_nat",
             dict(window_msa_grouped=0, window_msa_nat=6, window_msa=8))):
        os.environ[flag] = "1"
        reset_counts()
        pred = fwd()
        torch.cuda.synchronize()
        got = counts()
        os.environ.pop(flag)
        err = rel_err(torch, pred, ref)
        print(f"cli weights, batch 2, {flag}=1: launches "
              f"{ {k: got[k] for k in want} }, pred vs the default path "
              f"err/max|ref| {err:.3e} (limit 2e-2)", flush=True)
        if {k: got[k] for k in want} != want or not err <= 2e-2:
            raise SystemExit(f"{flag}: launches {got}, err {err}")
        report["launches"][kernel] = got[kernel]
        report["layouts"][flag] = err

    # -- the command line itself, in a process of its own -------------------
    sub = os.path.join(root, "subprocess")
    cmd = [sys.executable, "-m", "tulip_tpu_torch.main_lidar_upsampling",
           *cli_flags(data_root, sub, "--epochs", "1", *sched)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    print(f"cli subprocess: python3 -m tulip_tpu_torch.main_lidar_upsampling "
          f"... --epochs 1 exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode != 0 or not os.path.exists(
            os.path.join(sub, "checkpoint-0.pth")):
        raise SystemExit("cli subprocess failed:\n" + proc.stdout[-3000:]
                         + proc.stderr[-3000:])

    # -- the step with and without the LayerNorm kernels --------------------
    batches = load_batches(data_root, TRAIN_BATCH, 2048, split="train")
    ms = {False: [], True: []}
    colsums = {}
    for on in (False, True, True, False):
        reset_counts()
        ms[on].append(timed_steps(torch, dev, weights, batches, 10, on))
        colsums[on] = counts()["colsum"] / 10
    report["step_ms"] = dict(default=ms[False], ln_kernels=ms[True])
    report["colsum_per_step"] = dict(default=colsums[False],
                                     ln_kernels=colsums[True])
    print(f"train step, batch {TRAIN_BATCH}, bf16, median ms of 8 timed "
          f"steps, runs in the order off, on, on, off: default "
          f"{ms[False][0]:.2f} / {ms[False][1]:.2f}, TULIP_TPU_LN_PALLAS=1 "
          f"{ms[True][0]:.2f} / {ms[True][1]:.2f}; colsum launches per step "
          f"{colsums[False]:g} / {colsums[True]:g} (K15 adds "
          f"{colsums[True] - colsums[False]:g})", flush=True)
    if colsums[True] != colsums[False]:
        raise SystemExit(f"K15 launches colsum: {colsums}")
    return report


# phase 9(b): the global batch and the steps of the bf16 run
DP_GLOBAL_BATCH, DP_STEPS = 8, 3


def dp_steps(torch, dev, root, rank, world, profile=False, mesh=None,
             rates=None, dtypes=("fp32", "bf16"), ln_kernels=False):
    """Phase 9(b)'s training, as rank ``rank`` of ``world`` (1: one process,
    no group): the flagship with drop_path_rate 0.1 from root/weights.pt,
    on rows [rank * b, (rank + 1) * b) of the batch in root/batch.npz, the
    drop-path draws of the whole batch from one generator seeded 0; one
    fp32 step and DP_STEPS bf16 steps (of ``dtypes``).  Under a
    sequence-parallel ``mesh`` (phase 10) the rows are the data index's and
    the rank takes its W shard of them through make_sp_train_step.
    ``rates``: the model's (drop_rate, attn_drop_rate), drawn from the same
    generator; ``ln_kernels``: TULIP_TPU_LN_PALLAS=1 around the steps.
    Returns, for each type, the first update's gradient (fp32, on the CPU),
    the losses, the step ms and, for bf16, the weights after the last step
    and the kernel launches and halo exchanges a step; with ``profile``,
    the device us by kernel name of one more bf16 step and of one average_
    of the step's gradients (every rank runs them: they hold
    collectives)."""
    from tulip_tpu_torch.models.layers import RankDraws
    from tulip_tpu_torch.models.tulip import tulip_base
    from tulip_tpu_torch.parallel import dist, halo
    from tulip_tpu_torch.parallel.mesh import replicate
    from tulip_tpu_torch.parallel.sp import make_sp_train_step, shard_w
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    d, dp = (rank, world) if mesh is None else (mesh.data_index, mesh.dp)
    with np.load(os.path.join(root, "batch.npz")) as f:
        b = f["low"].shape[0] // dp
        low, high = (torch.from_numpy(f[k][d * b:(d + 1) * b]).to(dev)
                     for k in ("low", "high"))
    if mesh is not None:
        low, high = shard_w(low, mesh), shard_w(high, mesh)
    out = {}
    drop = {} if rates is None else dict(drop_rate=rates[0],
                                         attn_drop_rate=rates[1])
    saved_ln = os.environ.pop("TULIP_TPU_LN_PALLAS", None)
    if ln_kernels:
        os.environ["TULIP_TPU_LN_PALLAS"] = "1"
    for name, dtype, steps in (("fp32", torch.float32, 1),
                               ("bf16", torch.bfloat16, DP_STEPS)):
        if name not in dtypes:
            continue
        model = tulip_base(drop_path_rate=0.1, **drop, **FLAGSHIP)
        model.load_state_dict(weights, strict=True)
        model = model.to(dev)
        replicate(model)
        opt = make_optimizer(model, 0.01)
        grads, opt_step = [], opt.step

        def recording_step(*a, **k):
            if not grads:
                grads.append({n: p.grad.detach().float().cpu()
                              for n, p in model.named_parameters()})
            return opt_step(*a, **k)

        opt.step = recording_step
        step = (make_train_step(model, opt, compute_dtype=dtype)
                if mesh is None else
                make_sp_train_step(model, opt, mesh, compute_dtype=dtype))
        gen = torch.Generator(device=dev).manual_seed(0)
        draws = gen if world == 1 else RankDraws(gen, d, dp)
        losses, ms = [], []
        reset_counts()
        ex = halo.exchanges()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, pixel = step(low, high, 5e-4, draws)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append((total.item(), pixel.item()))
        out[name] = dict(grads=grads[0], losses=losses, ms=ms)
        if name == "bf16":
            out[name]["weights"] = {n: p.detach().cpu()
                                    for n, p in model.named_parameters()}
            out[name]["launches"] = {k: v // steps
                                     for k, v in counts().items()}
            out[name]["exchanges"] = (halo.exchanges() - ex) // steps
            if profile:
                g = [torch.randn_like(p) for p in model.parameters()]
                out["profile"] = dict(
                    step=device_us(torch, lambda: step(low, high, 5e-4,
                                                       draws), n=3),
                    average=device_us(torch, lambda: dist.average_(g), n=5))
        del model, opt, step
        torch.cuda.empty_cache()
    os.environ.pop("TULIP_TPU_LN_PALLAS", None)
    if saved_ln is not None:
        os.environ["TULIP_TPU_LN_PALLAS"] = saved_ln
    return out


# phase 10: the batch of the sequence-parallel train steps, the batches of
# the forwards held against one process and of the timed ones
SP_BATCH = 4
SP_CHECKED, SP_TIMED = (1, 4), (1, 8)


def sp_forwards(torch, dev, root, mesh, profile=False):
    """Phase 10 (a, c, d) on this rank of ``mesh`` (None: one process on
    the whole scans, the reference): the flagship from
    root/weights.pt in fp32 and bf16, mode "eval", on this rank's W shard
    of each batch x{B} in root/forward.npz.  Returns the local preds at
    the SP_CHECKED batches (on the CPU; the caller joins the shards), the
    K1 / K2 launches and the halo exchanges of each forward (the counts
    set to 0 just before it), the bf16 forward's median ms at the
    SP_TIMED batches (host clock around synchronised forwards, every rank
    in step), with ``profile`` their device us by kernel name, and the
    exchanges' transport."""
    from tulip_tpu_torch.models.tulip import apply_model, tulip_base
    from tulip_tpu_torch.parallel import halo
    from tulip_tpu_torch.parallel.sp import make_sp_forward, shard_w
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    with np.load(os.path.join(root, "forward.npz")) as f:
        xs = {int(k[1:]): f[k] for k in f.files}
    out = dict(preds={}, launches={}, exchanges={}, ms={}, profile={})
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = tulip_base(**FLAGSHIP)
        model.load_state_dict(weights, strict=True)
        model = model.to(device=dev, dtype=dtype)
        if mesh is None:    # one process on the whole scans
            def run(x):
                return apply_model(model, x, mc_drop=True,
                                   compute_dtype=dtype)
        else:
            run = make_sp_forward(model, mesh, mode="eval",
                                  compute_dtype=dtype)
        for b, x in sorted(xs.items()):
            xl = torch.from_numpy(x).to(dev)
            if mesh is not None:
                xl = shard_w(xl, mesh)
            reset_counts()
            ex = halo.exchanges()
            pred = run(xl)
            torch.cuda.synchronize()
            c = counts()
            key = f"{name} batch {b}"
            out["launches"][key] = dict(
                K1=c["window_msa"] - c["window_msa_many_heads"],
                K2=c["window_msa_many_heads"])
            out["exchanges"][key] = halo.exchanges() - ex
            if b in SP_CHECKED:
                out["preds"][key] = pred.float().cpu()
            if name == "bf16" and b in SP_TIMED:
                for _ in range(3):
                    run(xl)
                times = []
                for _ in range(20):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(xl)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                out["ms"][b] = statistics.median(times)
                if profile:
                    out["profile"][b] = device_us(torch, lambda: run(xl),
                                                  n=5)
        del model, run
        torch.cuda.empty_cache()
    out["transport"] = dict(halo.TRANSPORT)
    return out


# phase 10 (e): dropout on the flagship at phase 11(d)'s rates
SP_RATES = (0.1, 0.1)


def sp_dropout_forwards(torch, dev, root, mesh, profile=False):
    """Phase 10 (e) on this rank of ``mesh`` (None: one process on the
    whole scans): the flagship from root/weights.pt with dropout SP_RATES,
    mode "mc", in fp32 and bf16, on this rank's W shard of the batches
    SP_TIMED in root/forward.npz; each forward's masks from a generator on
    the card seeded by its batch, alike on every rank.  Returns the local
    preds (on the CPU), the kernel launches of each forward (the counts set
    to 0 just before it), the elements its dropout sites draw and the
    elements they keep (the shard's), the bf16 forward's median ms (host
    clock around synchronised forwards, every rank in step) and, with
    ``profile``, the device us by kernel name of one bf16 forward at the
    largest batch."""
    from tulip_tpu_torch.models import layers as L
    from tulip_tpu_torch.models.tulip import apply_model, tulip_base
    from tulip_tpu_torch.parallel.sp import make_sp_forward, shard_w
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    with np.load(os.path.join(root, "forward.npz")) as f:
        xs = {b: f[f"x{b}"] for b in SP_TIMED}
    out = dict(preds={}, launches={}, drawn={}, ms={}, profile={})
    dropout, drawn = L.dropout, [0, 0]

    def counting(x, rate, draws, active, grid=None):
        if active and rate > 0 and draws is not None:
            drawn[0] += x.numel() * getattr(draws, "n_seq", 1)
            drawn[1] += x.numel()
        return dropout(x, rate, draws, active, grid)

    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = tulip_base(drop_rate=SP_RATES[0], attn_drop_rate=SP_RATES[1],
                           **FLAGSHIP)
        model.load_state_dict(weights, strict=True)
        model = model.to(device=dev, dtype=dtype)
        if mesh is None:
            def run(x, g):
                return apply_model(model, x, mode="mc", mc_drop=True,
                                   compute_dtype=dtype, generator=g)
        else:
            fwd = make_sp_forward(model, mesh, mode="mc",
                                  compute_dtype=dtype)

            def run(x, g):
                return fwd(x, generator=g)
        for b, x in sorted(xs.items()):
            xl = torch.from_numpy(x).to(dev)
            if mesh is not None:
                xl = shard_w(xl, mesh)
            key = f"{name} batch {b}"
            reset_counts()
            drawn[:] = [0, 0]
            L.dropout = counting
            try:
                pred = run(xl, torch.Generator(device=dev).manual_seed(b))
                torch.cuda.synchronize()
            finally:
                L.dropout = dropout
            out["launches"][key] = {k: v for k, v in counts().items() if v}
            out["drawn"][key] = tuple(drawn)
            out["preds"][key] = pred.float().cpu()
            if name != "bf16":
                continue
            g = torch.Generator(device=dev).manual_seed(b)
            for _ in range(3):
                run(xl, g)
            times = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(xl, g)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["ms"][b] = statistics.median(times)
            if profile and b == max(SP_TIMED):
                out["profile"][b] = device_us(torch, lambda: run(xl, g), n=3)
        del model, run
        torch.cuda.empty_cache()
    return out


def draw_ms(prof):
    """The device ms of a profile's random draws (PyTorch's uniform
    kernel, distribution_elementwise_grid_stride_kernel)."""
    return sum(v for k, v in prof.items() if "distribution" in k) / 1e3


def dp_rank_main(rank, root):
    """``chip_smoke.py --dp-rank R DIR``: rank R of the group that
    DIR/spec.json describes ({"backend", "devices": one per rank,
    "profile", "sp": the seq degree, 1 for data parallel alone, "dropout":
    phase 10 (e) too}); the result goes to DIR/rank{R}.pt."""
    import torch
    import torch.distributed as td
    from tulip_tpu_torch.parallel.mesh import make_mesh
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    dev = torch.device(spec["devices"][rank])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(dev)
    world, sp = len(spec["devices"]), spec.get("sp", 1)
    td.init_process_group(spec["backend"], store=td.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh(sp) if sp > 1 else None
        out = dp_steps(torch, dev, root, rank, world, spec["profile"], mesh)
        if mesh is not None:
            out["sp"] = sp_forwards(torch, dev, root, mesh, spec["profile"])
        if spec.get("dropout"):
            out["dropout"] = dict(
                forwards=sp_dropout_forwards(torch, dev, root, mesh,
                                             spec["profile"]),
                steps=dp_steps(torch, dev, root, rank, world, mesh=mesh,
                               rates=SP_RATES),
                ln=dp_steps(torch, dev, root, rank, world, mesh=mesh,
                            dtypes=("bf16",), ln_kernels=True))
    finally:
        td.destroy_process_group()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    return 0


def run_processes(cmds, timeout, cwd=REPO, env=None):
    """Run the commands side by side with their output in files beside
    them; when one fails or the time limit passes, kill the rest (a rank
    left alone waits in a collective for ever).  Returns the wall s."""
    logs, procs = [], []
    t0 = time.perf_counter()
    try:
        for i, cmd in enumerate(cmds):
            logs.append(open(os.path.join(cwd, f"proc{i}.log"), "w+"))
            procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, env=env))
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.perf_counter() - t0 > timeout):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit("processes failed: "
                         + " | ".join(f"exit {p.returncode}: {t[-3000:]}"
                                      for p, t in zip(procs, texts)))
    return time.perf_counter() - t0


def run_dp_ranks(torch, dev, weights, data_root, root, backend, devices,
                 label):
    """Phase 9(b): len(devices) ranks of ``backend``, processes of their own
    on ``devices``, DP_GLOBAL_BATCH / len(devices) scans each, against one
    process on ``dev`` on the joined batch of DP_GLOBAL_BATCH (data_root's
    train split), drop_path_rate 0.1: fp32 reduced gradients within 1e-4
    of each parameter's max|ref|, bf16 gradient cosine >= 0.999, the ranks'
    gradients and weights equal bit for bit."""
    world = len(devices)
    profile = backend == "nccl"   # gloo on one card times host copies
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(dict(backend=backend, devices=devices, profile=profile), f)
    torch.save(weights, os.path.join(root, "weights.pt"))
    width = FLAGSHIP["img_size"][1]
    low, high = load_batches(data_root, DP_GLOBAL_BATCH, width,
                             split="train")[0]
    np.savez(os.path.join(root, "batch.npz"), low=low["sample"],
             high=high["sample"])
    wall = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
          root] for r in range(world)], timeout=600, cwd=root)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    ref = dp_steps(torch, dev, root, 0, 1)
    g32 = ranks[0]["fp32"]["grads"]
    errs = {k: rel_err(torch, g32[k], v)
            for k, v in ref["fp32"]["grads"].items()}
    worst = max(errs, key=errs.get)
    _, _, cos = grad_check(torch, (0.0, ranks[0]["bf16"]["grads"]),
                           (1.0, ref["bf16"]["grads"]))
    same = {name: all(torch.equal(v, r[name]["grads"][k])
                      for r in ranks[1:]
                      for k, v in ranks[0][name]["grads"].items())
            for name in ("fp32", "bf16")}
    w0 = ranks[0]["bf16"]["weights"]
    same_w = all(torch.equal(v, r["bf16"]["weights"][k])
                 for r in ranks[1:] for k, v in w0.items())
    moved = max(float((w0[k] - weights[k]).abs().max()) for k in w0)
    rank_ms = [statistics.median(r["bf16"]["ms"][1:]) for r in ranks]
    print(f"dp {label}: {world} {backend} ranks on {sorted(set(devices))}, "
          f"batch {DP_GLOBAL_BATCH // world} each, against one process at "
          f"batch {DP_GLOBAL_BATCH}, drop_path_rate 0.1: fp32 reduced "
          f"gradient worst {worst} err/max|ref| {errs[worst]:.2e} (limit "
          f"1e-4), loss {ranks[0]['fp32']['losses']} vs "
          f"{ref['fp32']['losses']}; bf16 gradient cosine {cos:.6f} (limit "
          f"0.999); the ranks' reduced gradients bit-equal {same}, weights "
          f"after {DP_STEPS} bf16 steps bit-equal {same_w} (moved "
          f"{moved:.2e}); bf16 step ms, the host clock around each step "
          f"(after the first): ranks {[round(m, 2) for m in rank_ms]}, one "
          f"process {statistics.median(ref['bf16']['ms'][1:]):.2f}; the "
          f"ranks' wall {wall:.1f} s", flush=True)
    if not (errs[worst] <= 1e-4 and cos >= 0.999 and all(same.values())
            and same_w and moved > 0):
        raise SystemExit(f"dp {label}: the ranks disagree with one process "
                         "or with each other")
    report = dict(
        backend=backend, devices=devices,
        fp32_worst_grad=worst, fp32_worst_grad_err=errs[worst],
        bf16_grad_cos=cos, ranks_bit_equal=same_w,
        losses=[r["bf16"]["losses"] for r in ranks],
        one_process_losses=ref["bf16"]["losses"], rank_step_ms=rank_ms,
        one_process_step_ms=ref["bf16"]["ms"])
    if profile:
        prof = ranks[0]["profile"]
        nccl = {k: v for k, v in prof["step"].items() if "nccl" in k.lower()}
        report.update(
            step_device_ms=sum(prof["step"].values()) / 1e3,
            step_nccl_us=nccl, average_device_us=prof["average"])
        print(f"dp {label}: rank 0's bf16 step {report['step_device_ms']:.3f}"
              f" ms of device time, NCCL kernels a step "
              f"{ {k[:60]: round(v, 1) for k, v in nccl.items()} } us; one "
              f"average_ of the step's gradients "
              f"{sum(prof['average'].values()) / 1e3:.4f} ms "
              f"({ {k[:60]: round(v, 1) for k, v in prof['average'].items()} }"
              f" us)", flush=True)
        if not nccl:
            raise SystemExit(f"dp {label}: the profiler saw no NCCL kernel")
    return report


def exchange_us(prof):
    """The device us of a profile's halo exchanges: NCCL's point-to-point
    kernels, or under gloo the host-staging copies (of the exchanges, and
    in a step of gloo's all-reduce too)."""
    return sum(v for k, v in prof.items()
               if ("nccl" in k.lower() and "allreduce" not in k.lower())
               or "memcpy" in k.lower())


def steps_against_one(torch, ranks, ref, weights):
    """The ranks' first-update gradients and last weights (dp_steps
    results) against one process's: (the worst fp32 gradient and its
    err / max|ref| or None without fp32, the bf16 gradient cosine, every
    rank's gradients bit-equal, its weights bit-equal, the largest move)."""
    worst = err = None
    if "fp32" in ref:
        g32 = ranks[0]["fp32"]["grads"]
        errs = {k: rel_err(torch, g32[k], v)
                for k, v in ref["fp32"]["grads"].items()}
        worst = max(errs, key=errs.get)
        err = errs[worst]
    _, _, cos = grad_check(torch, (0.0, ranks[0]["bf16"]["grads"]),
                           (1.0, ref["bf16"]["grads"]))
    same = all(torch.equal(v, r[name]["grads"][k]) for r in ranks[1:]
               for name in ref for k, v in ranks[0][name]["grads"].items())
    w0 = ranks[0]["bf16"]["weights"]
    same_w = all(torch.equal(v, r["bf16"]["weights"][k])
                 for r in ranks[1:] for k, v in w0.items())
    moved = max(float((w0[k] - weights[k]).abs().max()) for k in w0)
    return worst, err, cos, same, same_w, moved


def check_sp_dropout(torch, dev, root, ranks, sp, label, weights,
                     want_step_ex):
    """Phase 10 (e), the ranks' dropout results (sp_dropout_forwards and
    the two extra dp_steps of dp_rank_main) against one process on ``dev``:
    the "mc" forwards' joined preds within 1e-4 (fp32) / 3e-2 (bf16) of
    max|ref| on the same generator seeds, each rank's launches a forward
    those of one process (MC_PER_FORWARD) and the elements drawn one
    process's (the shard keeps 1 / sp of them); the dropout train steps
    (fp32 gradients within 1e-4 of each parameter's max|ref|, the bf16
    cosine >= 0.999, the ranks bit-equal, DROPOUT_PER_STEP launches and
    the exchanges of a step as without dropout); the bf16 steps with
    TULIP_TPU_LN_PALLAS=1 (K14 / K15 on the shards, PER_STEP_CLI launches)
    with the same bf16 limits.  Prints the forward's and the step's ms
    against one process and the draws' device ms."""
    world = len(ranks)
    ref_fwd = sp_dropout_forwards(torch, dev, root, None, profile=True)
    ref_steps = dp_steps(torch, dev, root, 0, 1, rates=SP_RATES)
    ref_ln = dp_steps(torch, dev, root, 0, 1, dtypes=("bf16",),
                      ln_kernels=True)
    fwds = [r["dropout"]["forwards"] for r in ranks]
    errs = {}
    for key, want in ref_fwd["preds"].items():
        errs[key] = max(
            rel_err(torch, torch.cat([fwds[d * sp + s]["preds"][key]
                                      for s in range(sp)], dim=-1), want)
            for d in range(world // sp))
    fwd_ok = all(v <= (1e-4 if k.startswith("fp32") else 3e-2)
                 for k, v in errs.items())
    kernels = set(SOURCES)
    launches = [{k: {n: c for n, c in v.items() if n in kernels}
                 for k, v in f["launches"].items()} for f in fwds]
    ref_launches = {k: {n: c for n, c in v.items() if n in kernels}
                    for k, v in ref_fwd["launches"].items()}
    want_fwd = {k: v for k, v in MC_PER_FORWARD.items() if v}
    launch_ok = all(x == ref_launches for x in launches) and all(
        v == want_fwd for v in ref_launches.values())
    drawn_ok = all(f["drawn"][k][0] == ref_fwd["drawn"][k][0]
                   and f["drawn"][k][1] * sp == f["drawn"][k][0]
                   for f in fwds for k in ref_fwd["drawn"])
    steps = [r["dropout"]["steps"] for r in ranks]
    worst, err, cos, same, same_w, moved = steps_against_one(
        torch, steps, ref_steps, weights)
    step_launches = [{k: s["bf16"]["launches"][k] for k in DROPOUT_PER_STEP}
                     for s in steps]
    step_ex = {s["bf16"]["exchanges"] for s in steps}
    ln = [r["dropout"]["ln"] for r in ranks]
    _, _, ln_cos, ln_same, ln_same_w, ln_moved = steps_against_one(
        torch, ln, ref_ln, weights)
    ln_launches = [{k: s["bf16"]["launches"][k] for k in PER_STEP_CLI}
                   for s in ln]
    big = max(SP_TIMED)
    rank_draw = draw_ms(fwds[0]["profile"][big])
    one_draw = draw_ms(ref_fwd["profile"][big])
    rank_dev = sum(fwds[0]["profile"][big].values()) / 1e3
    one_dev = sum(ref_fwd["profile"][big].values()) / 1e3
    step_ms = statistics.median(steps[0]["bf16"]["ms"][1:])
    one_step_ms = statistics.median(ref_steps["bf16"]["ms"][1:])
    ln_ms = statistics.median(ln[0]["bf16"]["ms"][1:])
    one_ln_ms = statistics.median(ref_ln["bf16"]["ms"][1:])
    print(f"sp {label} (e) dropout {SP_RATES[0]} / {SP_RATES[1]}: 'mc' "
          f"forwards against one process on the same seeds, err/max|ref| "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (limits fp32 1e-4, "
          f"bf16 3e-2); kernel launches a forward on each rank "
          f"{launches[0]} (one process's: "
          f"{all(x == ref_launches for x in launches)}); elements drawn / "
          f"kept a forward {fwds[0]['drawn']} (one process draws "
          f"{ref_fwd['drawn']})", flush=True)
    print(f"sp {label} (e) dropout train steps at batch {SP_BATCH}, "
          f"drop_path_rate 0.1: fp32 gradient worst {worst} err/max|ref| "
          f"{err:.2e} (limit 1e-4), bf16 gradient cosine {cos:.6f} (limit "
          f"0.999); every rank's gradients bit-equal {same}, weights after "
          f"{DP_STEPS} bf16 steps bit-equal {same_w} (moved {moved:.2e}); "
          f"launches a step {step_launches[0]}, exchanges a step "
          f"{sorted(step_ex)} (want {want_step_ex})", flush=True)
    print(f"sp {label} (e) TULIP_TPU_LN_PALLAS=1 bf16 steps: gradient "
          f"cosine {ln_cos:.6f} (limit 0.999), gradients bit-equal "
          f"{ln_same}, weights bit-equal {ln_same_w} (moved {ln_moved:.2e}); "
          f"launches a step {ln_launches[0]} (want {PER_STEP_CLI})",
          flush=True)
    print(f"sp {label} (e) times: bf16 'mc' forward ms (host clock, median "
          f"of 20) { {b: round(v, 3) for b, v in fwds[0]['ms'].items()} } "
          f"against one process "
          f"{ {b: round(v, 3) for b, v in ref_fwd['ms'].items()} }; batch "
          f"{big}: rank 0's device ms a forward {rank_dev:.3f}, of it the "
          f"draws {rank_draw:.4f}; one process {one_dev:.3f}, of it the "
          f"draws {one_draw:.4f}; bf16 dropout step ms (host clock) rank 0 "
          f"{step_ms:.2f}, one process {one_step_ms:.2f}; LN-switch step "
          f"rank 0 {ln_ms:.2f}, one process {one_ln_ms:.2f}", flush=True)
    ok = (fwd_ok and launch_ok and drawn_ok and err <= 1e-4
          and cos >= 0.999 and same and same_w and moved > 0
          and all(x == DROPOUT_PER_STEP for x in step_launches)
          and step_ex == {want_step_ex} and ln_cos >= 0.999 and ln_same
          and ln_same_w and ln_moved > 0
          and all(x == PER_STEP_CLI for x in ln_launches))
    if not ok:
        raise SystemExit(f"sp {label} (e): dropout or the LN switch "
                         "disagrees with one process, with the other ranks "
                         "or with the counts")
    return dict(rates=SP_RATES, forward_err=errs,
                launches_per_forward=launches[0], drawn=fwds[0]["drawn"],
                one_drawn=ref_fwd["drawn"], forward_ms=fwds[0]["ms"],
                one_forward_ms=ref_fwd["ms"], forward_device_ms=rank_dev,
                one_forward_device_ms=one_dev, draw_device_ms=rank_draw,
                one_draw_device_ms=one_draw, fp32_worst_grad=worst,
                fp32_worst_grad_err=err, bf16_grad_cos=cos,
                step_launches=step_launches[0], step_ms=steps[0]["bf16"]["ms"],
                one_step_ms=ref_steps["bf16"]["ms"], ln_grad_cos=ln_cos,
                ln_step_launches=ln_launches[0], ln_step_ms=ln[0]["bf16"]["ms"],
                one_ln_step_ms=ref_ln["bf16"]["ms"])


def run_sp_ranks(torch, dev, weights, data_root, root, backend, devices, sp,
                 label, dropout=False):
    """Phase 10 and ``--ranks N``'s sequence parallel: len(devices) ranks of
    ``backend`` as (world // sp) x sp, processes of their own, against one
    process on ``dev``, the flagship from the same weights.  (a) the
    fp32 and bf16 forwards at batch 1 and 4 (each data index runs the whole
    batch; its shards joined in seq order) within 1e-4 / 3e-2 of max|ref|;
    (b) one fp32 and DP_STEPS bf16 train steps at batch SP_BATCH (each data
    index its rows), drop_path_rate 0.1: fp32 gradients within 1e-4 of
    each parameter's max|ref|, the bf16 gradient's cosine >= 0.999, every
    rank's gradients and weights bit-equal; (c) K1 / K2 launches per
    forward on every rank those of one process (8 / 6: a launch a block
    of <= 8 / > 8 heads), the train kernels' per step as one process's;
    (d) two halo exchanges a shifted block and one for the patch embed's
    pad a forward (15), the rolls' again backward (29 a step).  Times: the
    bf16 forward's ms at batch 1 and 8 against one process, and rank 0's
    device time of the step and of the exchanges (profiler).  With
    ``dropout``: (e), check_sp_dropout."""
    from tulip_tpu_torch.config import model_config
    world = len(devices)
    cfg = model_config("tulip_base", **FLAGSHIP)
    stages = cfg.encoder_stages + cfg.decoder_stages
    shifted = sum(st.depth // 2 for st in stages)
    want_fwd, want_step_ex = 2 * shifted + 1, 4 * shifted + 1
    want_l = {(("K1", sum(st.depth for st in stages if st.num_heads <= 8)),
               ("K2", sum(st.depth for st in stages if st.num_heads > 8)))}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(dict(backend=backend, devices=devices, profile=True,
                       sp=sp, dropout=dropout), f)
    torch.save(weights, os.path.join(root, "weights.pt"))
    width = FLAGSHIP["img_size"][1]
    low, high = load_batches(data_root, SP_BATCH, width, split="train")[0]
    np.savez(os.path.join(root, "batch.npz"), low=low["sample"],
             high=high["sample"])
    np.savez(os.path.join(root, "forward.npz"), **{
        f"x{b}": load_batches(data_root, b, width, split="train")[0][0]
        ["sample"] for b in sorted(set(SP_CHECKED + SP_TIMED))})
    wall = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
          root] for r in range(world)], timeout=900, cwd=root)
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True)
             for r in range(world)]
    ref_fwd = sp_forwards(torch, dev, root, None)
    ref = dp_steps(torch, dev, root, 0, 1)
    fwd = {}
    for key, want in ref_fwd["preds"].items():
        errs = []
        for d in range(world // sp):
            got = torch.cat([ranks[d * sp + s]["sp"]["preds"][key]
                             for s in range(sp)], dim=-1)
            errs.append(rel_err(torch, got, want))
        fwd[key] = max(errs)
    fwd_ok = all(v <= (1e-4 if k.startswith("fp32") else 3e-2)
                 for k, v in fwd.items())
    launches = {r: set(map(lambda v: tuple(sorted(v.items())),
                           rk["sp"]["launches"].values()))
                for r, rk in enumerate(ranks)}
    ex_fwd = {v for rk in ranks for v in rk["sp"]["exchanges"].values()}
    ex_step = {rk["bf16"]["exchanges"] for rk in ranks}
    want_step = {k: v for k, v in PER_STEP.items() if v}
    step_launches = [{k: rk["bf16"]["launches"][k] for k in want_step}
                     for rk in ranks]
    g32 = ranks[0]["fp32"]["grads"]
    errs = {k: rel_err(torch, g32[k], v)
            for k, v in ref["fp32"]["grads"].items()}
    worst = max(errs, key=errs.get)
    _, _, cos = grad_check(torch, (0.0, ranks[0]["bf16"]["grads"]),
                           (1.0, ref["bf16"]["grads"]))
    same = all(torch.equal(v, r[name]["grads"][k]) for r in ranks[1:]
               for name in ("fp32", "bf16")
               for k, v in ranks[0][name]["grads"].items())
    w0 = ranks[0]["bf16"]["weights"]
    same_w = all(torch.equal(v, r["bf16"]["weights"][k])
                 for r in ranks[1:] for k, v in w0.items())
    moved = max(float((w0[k] - weights[k]).abs().max()) for k in w0)
    transport = ranks[0]["sp"]["transport"]
    prof = ranks[0]["profile"]
    step_ms = sum(prof["step"].values()) / 1e3
    step_ex_ms = exchange_us(prof["step"]) / 1e3
    fwd_ex_ms = {b: exchange_us(p) / 1e3
                 for b, p in ranks[0]["sp"]["profile"].items()}
    fwd_dev_ms = {b: sum(p.values()) / 1e3
                  for b, p in ranks[0]["sp"]["profile"].items()}
    print(f"sp {label}: {world} {backend} ranks as {world // sp} data x {sp} "
          f"seq on {sorted(set(devices))}, transport {transport}; "
          f"forwards against one process, err/max|ref| "
          f"{ {k: f'{v:.2e}' for k, v in fwd.items()} } (limits fp32 1e-4, "
          f"bf16 3e-2); K1 / K2 launches per forward on each rank "
          f"{sorted(set().union(*launches.values()))} (want {want_l}); "
          f"exchanges a forward {sorted(ex_fwd)} (want {want_fwd}), a step "
          f"{sorted(ex_step)} (want {want_step_ex}); train kernels a step on "
          "each rank "
          f"{step_launches[0]} (all ranks alike: "
          f"{all(x == step_launches[0] for x in step_launches)})", flush=True)
    print(f"sp {label}: batch {SP_BATCH}, drop_path_rate 0.1, against one "
          f"process: fp32 gradient worst {worst} err/max|ref| "
          f"{errs[worst]:.2e} (limit 1e-4), losses "
          f"{ranks[0]['fp32']['losses']} vs {ref['fp32']['losses']}; bf16 "
          f"gradient cosine {cos:.6f} (limit 0.999); every rank's gradients "
          f"bit-equal {same}, weights after {DP_STEPS} bf16 steps bit-equal "
          f"{same_w} (moved {moved:.2e})", flush=True)
    print(f"sp {label}: bf16 forward ms (host clock, median of 20) "
          f"{ {b: round(v, 3) for b, v in ranks[0]['sp']['ms'].items()} } "
          f"against one process "
          f"{ {b: round(v, 3) for b, v in ref_fwd['ms'].items()} }; rank "
          f"0's device ms a forward {fwd_dev_ms}, of it exchanges "
          f"{fwd_ex_ms}; rank 0's bf16 step {step_ms:.3f} ms of device "
          f"time, of it exchanges {step_ex_ms:.4f}; step ms (host clock) "
          f"rank 0 {statistics.median(ranks[0]['bf16']['ms'][1:]):.2f}, "
          f"one process {statistics.median(ref['bf16']['ms'][1:]):.2f}; "
          f"the ranks' wall {wall:.1f} s", flush=True)
    ok = (fwd_ok and all(v == want_l for v in launches.values())
          and ex_fwd == {want_fwd} and ex_step == {want_step_ex}
          and all(x == want_step for x in step_launches)
          and errs[worst] <= 1e-4 and cos >= 0.999 and same and same_w
          and moved > 0)
    if backend == "nccl" and set(transport) != {"nccl"}:
        ok = False
        print(f"sp {label}: an exchange left the devices: {transport}")
    if not ok:
        raise SystemExit(f"sp {label}: the ranks disagree with one process, "
                         "with each other or with the counts")
    drop_report = (check_sp_dropout(torch, dev, root, ranks, sp, label,
                                    weights, want_step_ex)
                   if dropout else None)
    return dict(backend=backend, devices=devices, sp=sp, dp=world // sp,
                dropout=drop_report,
                transport=transport, forward_err=fwd,
                launches_per_forward=[dict(v) for v in want_l],
                shifted_blocks=shifted,
                exchanges_per_forward=sorted(ex_fwd),
                exchanges_per_step=sorted(ex_step),
                step_launches=step_launches[0],
                fp32_worst_grad=worst, fp32_worst_grad_err=errs[worst],
                bf16_grad_cos=cos, ranks_bit_equal=same_w,
                forward_ms=ranks[0]["sp"]["ms"], one_forward_ms=ref_fwd["ms"],
                forward_device_ms=fwd_dev_ms, forward_exchange_ms=fwd_ex_ms,
                step_device_ms=step_ms, step_exchange_ms=step_ex_ms,
                step_ms=ranks[0]["bf16"]["ms"],
                one_step_ms=ref["bf16"]["ms"], wall_s=wall)


def sp_only(torch, dev) -> int:
    """``python3 chip_smoke.py --sp``: phase 10 alone, with (e), on the
    folder phase 8 writes (written here) and phase 4's weights; the report
    goes to chiprun_out/sp.json."""
    from tulip_tpu_torch.models.tulip import init_params, tulip_base
    cli_root = os.path.join(REPO, "build", "chip_smoke_cli", "durlar")
    write_durlar(cli_root, CLI_TRAIN, FLAGSHIP["img_size"][1], split="train")
    weights = init_params(tulip_base(**FLAGSHIP).cfg,
                          torch.Generator().manual_seed(0))
    report = run_sp_phase(torch, dev, weights)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sp.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


def run_sp_phase(torch, dev, weights):
    """Phase 10: W-axis sequence parallel on the one card, two gloo ranks
    (NCCL refuses two ranks on one GPU), against one process
    (run_sp_ranks)."""
    import shutil
    root = os.path.join(REPO, "build", "chip_smoke_sp")
    shutil.rmtree(root, ignore_errors=True)
    data_root = os.path.join(REPO, "build", "chip_smoke_cli", "durlar")
    return run_sp_ranks(
        torch, dev, weights, data_root, root, "gloo", [str(dev)] * 2, 2,
        "(one card, gloo: host-staged exchanges, not a multi-GPU time)",
        dropout=True)


CLI_LR = 5e-4   # the --lr of cli_flags


def cli_with_rates(drop, attn_drop, argv):
    """``chip_smoke.py --cli-rates D A FLAGS``: the port's command line on
    FLAGS with the model's dropout rates set to (D, A), as phase 11(d) sets
    them on the config (no flag sets a dropout rate, in either package)."""
    import dataclasses
    from tulip_tpu_torch import config
    from tulip_tpu_torch.main_lidar_upsampling import cli
    from_args = config.model_config_from_args
    config.model_config_from_args = lambda args: dataclasses.replace(
        from_args(args), drop_rate=drop, attn_drop_rate=attn_drop)
    cli(argv)
    return 0


def cli_command(launcher, flags, rates=None):
    """The argv of the port's command line on ``flags`` under ``launcher``
    (torchrun's, or none), through cli_with_rates where ``rates``."""
    entry = (["-m", "tulip_tpu_torch.main_lidar_upsampling"] if rates is None
             else [os.path.abspath(__file__), "--cli-rates",
                   *map(str, rates)])
    return [sys.executable, *launcher, *entry, *flags]


def ranks_cli_runs(torch, root, n, specs):
    """The command line's fp32 training, 2 epochs, once for each (name,
    batch, ranks, extra flags, data folder[, dropout rates]) of ``specs``:
    through torchrun over that many ranks, or in one process where ranks is
    0.  Returns {name: {log, model (checkpoint-1.pth's weights), s, tb}}."""
    runs = {}
    for name, batch, ranks, extra, data, *rates in specs:
        out = os.path.join(root, name)
        flags = cli_flags(data, out, "--epochs", "2", "--warmup_epochs",
                          "1", "--save_frequency", "1", "--precision", "fp32",
                          *extra)
        flags[flags.index("--batch_size") + 1] = str(batch)
        launcher = ["-m", "torch.distributed.run", "--standalone",
                    f"--nproc_per_node={ranks}"] if ranks else []
        os.makedirs(out)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        t = run_processes([cli_command(launcher, flags, *rates)],
                          timeout=900, cwd=out, env=env)
        ckpt = torch.load(os.path.join(out, "checkpoint-1.pth"),
                          weights_only=True)
        runs[name] = dict(log=read_log(out), model=ckpt["model"], s=t,
                          tb=len([f for f in os.listdir(out)
                                  if f.startswith("events.out.tfevents")]))
    return runs


def cli_gap(torch, ranks, one):
    """(the two runs' train_loss pairs by epoch, their relative
    differences, the weights' |diff|: max, share beyond 1e-2 lr, mean)."""
    d = torch.cat([(ranks["model"][k] - v).abs().reshape(-1)
                   for k, v in one["model"].items()])
    moves = dict(max=float(d.max()),
                 share=float((d > 1e-2 * CLI_LR).float().mean()),
                 mean=float(d.mean()))
    losses = [(a["train_loss"], b["train_loss"])
              for a, b in zip(ranks["log"], one["log"])]
    return losses, [abs(a - b) / abs(b) for a, b in losses], moves


def run_drift_check(torch, n):
    """``chip_smoke.py --ranks N --drift``: part (iv) of run_ranks_check
    over 16 fp32 steps (2 epochs of the 16-scan folder at batch N / 2):
    (N / 2) data x 2 seq through torchrun and data parallel alone over
    N / 2 ranks, each against one process at batch N / 2 on the same
    steps.  A measurement: it prints both loss and weight gaps beside
    run_ranks_check's limits and fails only if a run fails."""
    import shutil
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--ranks {n}: {torch.cuda.device_count()} GPU(s)")
    root = os.path.join(REPO, "build", "chip_smoke_drift")
    shutil.rmtree(root, ignore_errors=True)
    data_root = os.path.join(root, "durlar")
    write_durlar(data_root, CLI_TRAIN, FLAGSHIP["img_size"][1],
                 split="train")
    write_durlar(data_root, CLI_VAL, FLAGSHIP["img_size"][1], split="val")
    runs = ranks_cli_runs(torch, root, n, (
        ("sp_ranks", 1, n, ["--sp_degree", "2"], data_root),
        ("dp_half", 1, n // 2, [], data_root),
        ("sp_one", n // 2, 0, [], data_root)))
    steps = 2 * (CLI_TRAIN // (n // 2))
    report = dict(steps=steps)
    for name, label in (("sp_ranks", f"{n // 2} data x 2 seq"),
                        ("dp_half", f"data parallel alone, {n // 2} ranks")):
        losses, rel, moves = cli_gap(torch, runs[name], runs["sp_one"])
        print(f"drift {label} (torchrun, nccl, fp32, batch 1 a data index) "
              f"against one process at batch {n // 2}, {steps} steps: "
              f"train_loss {losses}, relative differences "
              f"{[f'{r:.3e}' for r in rel]} (run_ranks_check's limit 1e-5); "
              f"weights |diff| max {moves['max']:.3e} (limit "
              f"{2 * CLI_LR * steps:.1e}), share beyond 1e-2 lr "
              f"{moves['share']:.3e} (limit 5e-3), mean {moves['mean']:.3e} "
              f"(limit {1e-3 * CLI_LR:.1e}); wall {runs[name]['s']:.1f} s",
              flush=True)
        report[name] = dict(losses=losses, loss_rel_diff=rel,
                            weight_diff=moves, wall_s=runs[name]["s"])
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"drift{n}.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


def run_ranks_check(torch, n):
    """``chip_smoke.py --ranks N``: data parallel over N GPUs under NCCL,
    for a machine with N cards.  (i) The command line through
    ``torchrun --standalone --nproc_per_node=N`` in fp32, batch 1 a rank,
    2 epochs, against one process at batch N on one device (with batch 1 a
    rank, step k of the ranks' strides is the one process's step k, rows
    in the same order, so the drop-path draws fall on the same samples):
    one log.txt and one TensorBoard file, the losses within 1e-5 relative
    and the weights of checkpoint-1.pth within the AdamW limits of
    tests/test_torch_train.py at lr 5e-4 over the run's steps (every
    element within 2 lr a step, at most 0.5 % of them beyond 1e-2 lr, the
    mean below 1e-3 lr): AdamW's normalised update turns the rounding noise
    of a gradient entry near zero into a move of up to lr.
    (ii) Phase 9(b) over the N ranks, one device each, with rank 0's
    profile of the step and of one gradient average.
    W-axis sequence parallel over the N cards (NCCL): (iii) the command
    line's ``--eval --sp_degree N`` through torchrun, the results file
    against one process's eval of the same checkpoint (mae and chamfer
    within 1e-4 relative, the voxel ratios within 1e-3); (iv) its
    training as (N / 2) data x 2 seq through torchrun, batch 1 a data
    index, against one process at batch N / 2, as (i) and over (i)'s
    steps (a folder of half the scans), beside data parallel alone over
    N / 2 ranks on the same steps (a control of how far the ranks drift
    from one process without W shards); (vi) ``--eval --mc_drop
    --sp_degree N`` with dropout SP_RATES (cli_with_rates) through
    torchrun against one process at the same rates, on (iii)'s
    checkpoint, with (iii)'s limits; (vii) (iv) with dropout SP_RATES;
    (v) phase 10's
    forwards and steps at sp 2 (N / 2 data indices) and at sp N
    (run_sp_ranks), with their times."""
    import shutil
    from tulip_tpu_torch.models.tulip import init_params, tulip_base
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--ranks {n}: {torch.cuda.device_count()} GPU(s)")
    root = os.path.join(REPO, "build", "chip_smoke_ranks")
    shutil.rmtree(root, ignore_errors=True)
    data_root = os.path.join(root, "durlar")
    width = FLAGSHIP["img_size"][1]
    write_durlar(data_root, CLI_TRAIN, width, split="train")
    write_durlar(data_root, CLI_VAL, width, split="val")
    # (iv) runs N / 2 data indices on a folder of half the scans, so that
    # its steps are (i)'s: fp32 runs drift apart with the steps (AdamW
    # turns rounding noise into moves of up to lr), data parallel alone as
    # much as with W shards, and the limits below hold over (i)'s 8
    data_half = os.path.join(root, "durlar_half")
    write_durlar(data_half, CLI_TRAIN // 2, width, split="train")
    write_durlar(data_half, CLI_VAL, width, split="val")
    runs = ranks_cli_runs(torch, root, n, (
        ("ranks", 1, n, [], data_root), ("one", n, 0, [], data_root),
        ("sp_ranks", 1, n, ["--sp_degree", "2"], data_half),
        ("sp_one", n // 2, 0, [], data_half),
        ("dp_half", 1, n // 2, [], data_half)))
    lr = CLI_LR
    torchrun = ["-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={n}"]

    def cli_against_one(label, ranks, one, steps):
        losses, rel, moves = cli_gap(torch, ranks, one)
        ok = (len(ranks["log"]) == len(one["log"]) == 2 and ranks["tb"] == 1
              and all(r <= 1e-5 for r in rel)
              and moves["max"] <= 2 * lr * steps and moves["share"] <= 5e-3
              and moves["mean"] <= 1e-3 * lr)
        print(f"ranks {label}, {steps} steps: train_loss {losses} (relative "
              f"differences {[f'{r:.2e}' for r in rel]}, limit 1e-5); "
              f"weights |diff| max {moves['max']:.3e} (limit "
              f"{2 * lr * steps:.1e}), share beyond 1e-2 lr "
              f"{moves['share']:.2e} (limit 5e-3), mean {moves['mean']:.3e} "
              f"(limit {1e-3 * lr:.1e}); TensorBoard files {ranks['tb']}; "
              f"wall {ranks['s']:.1f} / {one['s']:.1f} s", flush=True)
        if not ok:
            failed.append(label)
        return dict(losses=losses, loss_rel_diff=rel, weight_diff=moves,
                    wall_s=[ranks["s"], one["s"]], ok=ok)

    failed = []

    cli_dp = cli_against_one(
        f"(i) torchrun --nproc_per_node={n} (nccl), fp32, batch 1 a rank, "
        f"against one process at batch {n}", runs["ranks"], runs["one"],
        2 * (CLI_TRAIN // n))
    cli_sp = cli_against_one(
        f"(iv) torchrun --nproc_per_node={n} --sp_degree 2 (nccl, {n // 2} "
        f"data x 2 seq), fp32, batch 1 a data index, against one process "
        f"at batch {n // 2}", runs["sp_ranks"], runs["sp_one"],
        2 * (CLI_TRAIN // 2 // (n // 2)))
    # the same steps as (iv) under data parallel alone: how far N / 2 ranks
    # of batch 1 drift from one process at batch N / 2 without W shards
    cli_dp_half = cli_against_one(
        f"(iv) control: torchrun --nproc_per_node={n // 2} (nccl, data "
        f"parallel alone), fp32, batch 1 a rank, against the same one "
        f"process at batch {n // 2}", runs["dp_half"], runs["sp_one"],
        2 * (CLI_TRAIN // 2 // (n // 2)))

    # (iii) --eval --sp_degree n through torchrun against one process, on
    # copies of the one-process run's last checkpoint
    results = {}
    for name, launcher, extra in (("eval_sp", torchrun,
                                   ["--sp_degree", str(n)]),
                                  ("eval_one", [], [])):
        out = os.path.join(root, name)
        os.makedirs(out)
        shutil.copy(os.path.join(root, "one", "checkpoint-1.pth"), out)
        t = run_processes([[sys.executable, *launcher, "-m",
                            "tulip_tpu_torch.main_lidar_upsampling",
                            *cli_flags(data_root, out, "--eval", *extra)]],
                          timeout=600, cwd=out,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
        with open(os.path.join(out, "results.txt")) as f:
            results[name] = dict(results=json.load(f), s=t)
    got, want = results["eval_sp"]["results"], results["eval_one"]["results"]
    eval_label = f"(iii) --eval --sp_degree {n} (torchrun, nccl)"
    eval_worst = None
    if {len(v) for v in got.values()} != {CLI_VAL}:
        print(f"{eval_label}: results of "
              f"{ {k: len(v) for k, v in got.items()} } scans, expected "
              f"{CLI_VAL}", flush=True)
        failed.append(eval_label)
    else:
        try:
            eval_worst = compare_results(
                f"{eval_label} against one process, {CLI_VAL} scans, wall "
                f"{results['eval_sp']['s']:.1f} / "
                f"{results['eval_one']['s']:.1f} s", got, want, 1e-4, 1e-3)
        except SystemExit as e:
            print(e, flush=True)
            failed.append(eval_label)
    # (vi) --eval --mc_drop --sp_degree n with dropout SP_RATES through
    # torchrun against one process at the same rates, on the same
    # checkpoint: the masks are one process's, each rank keeps its columns
    for name, launcher, extra in (("mc_sp", torchrun,
                                   ["--sp_degree", str(n)]),
                                  ("mc_one", [], [])):
        out = os.path.join(root, name)
        os.makedirs(out)
        shutil.copy(os.path.join(root, "one", "checkpoint-1.pth"), out)
        t = run_processes([cli_command(launcher, cli_flags(
            data_root, out, "--eval", "--mc_drop", *extra), SP_RATES)],
                          timeout=600, cwd=out,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
        with open(os.path.join(out, "results_mcdrop.txt")) as f:
            results[name] = dict(results=json.load(f), s=t)
    got, want = results["mc_sp"]["results"], results["mc_one"]["results"]
    mc_label = (f"(vi) --eval --mc_drop --sp_degree {n} (torchrun, nccl), "
                f"dropout {SP_RATES[0]} / {SP_RATES[1]}")
    mc_worst = None
    if {len(v) for v in got.values()} != {CLI_VAL}:
        print(f"{mc_label}: results of "
              f"{ {k: len(v) for k, v in got.items()} } scans, expected "
              f"{CLI_VAL}", flush=True)
        failed.append(mc_label)
    else:
        try:
            mc_worst = compare_results(
                f"{mc_label} against one process, {CLI_VAL} scans, wall "
                f"{results['mc_sp']['s']:.1f} / "
                f"{results['mc_one']['s']:.1f} s", got, want, 1e-4, 1e-3)
        except SystemExit as e:
            print(e, flush=True)
            failed.append(mc_label)
    # (vii) (iv) with dropout SP_RATES: 2 data x 2 seq against one process
    drop_runs = ranks_cli_runs(torch, root, n, (
        ("sp_drop_ranks", 1, n, ["--sp_degree", "2"], data_half, SP_RATES),
        ("sp_drop_one", n // 2, 0, [], data_half, SP_RATES)))
    cli_sp_drop = cli_against_one(
        f"(vii) torchrun --nproc_per_node={n} --sp_degree 2 (nccl, {n // 2} "
        f"data x 2 seq), dropout {SP_RATES[0]} / {SP_RATES[1]}, fp32, batch "
        f"1 a data index, against one process at batch {n // 2}",
        drop_runs["sp_drop_ranks"], drop_runs["sp_drop_one"],
        2 * (CLI_TRAIN // 2 // (n // 2)))
    cfg = tulip_base(**FLAGSHIP).cfg
    weights = init_params(cfg, torch.Generator().manual_seed(0))
    dp_root = os.path.join(root, "steps")
    os.makedirs(dp_root)
    report = run_dp_ranks(torch, torch.device("cuda", 0), weights, data_root,
                          dp_root, "nccl", [f"cuda:{r}" for r in range(n)],
                          f"(ii) nccl over {n} GPUs")
    report["cli"] = cli_dp
    report["cli_sp"] = cli_sp
    report["cli_dp_half"] = cli_dp_half
    report["eval_sp"] = dict(worst=eval_worst, results=results)
    report["mc_sp"] = dict(worst=mc_worst, rates=SP_RATES)
    report["cli_sp_dropout"] = cli_sp_drop
    report["sp"] = {}
    for sp in (2, n):
        label = f"(v) nccl over {n} GPUs, sp {sp}"
        try:
            report["sp"][sp] = run_sp_ranks(
                torch, torch.device("cuda", 0), weights, data_root,
                os.path.join(root, f"sp{sp}"), "nccl",
                [f"cuda:{r}" for r in range(n)], sp, label)
        except SystemExit as e:
            print(e, flush=True)
            failed.append(label)
    report["failed"] = failed
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"ranks{n}.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failed:
        raise SystemExit(f"--ranks {n}: failed: {failed}")
    return 0


def run_dp_phase(torch, dev, weights):
    """Phase 9: data parallel.  (a) the command line of phase 8 as rank 0
    of a launcher's world of 1 (a real NCCL group, file:// rendezvous),
    with the counts set to 0 just before it and read just after; the
    group's all-reduce per train step by the profiler; the step with and
    without the group.  (b) two gloo ranks in processes of their own on
    the card against one process on the joined batch."""
    import shutil
    import torch.distributed as td
    from tulip_tpu_torch.parallel import dist
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    from tulip_tpu_torch.models.tulip import tulip_base

    cli_root = os.path.join(REPO, "build", "chip_smoke_cli")
    data_root = os.path.join(cli_root, "durlar")
    root = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    report = {}

    # -- (a) one rank under nccl, against phase 8's run without a group ---
    one = os.path.join(root, "one_rank")
    backends = []
    init_group = td.init_process_group

    def recording_init(*a, **k):
        init_group(*a, **k)
        backends.append(td.get_backend())

    launcher = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(launcher, TULIP_TPU_LN_PALLAS="1")
    td.init_process_group = recording_init
    reset_counts()
    try:
        run_cli_train(cli_flags(
            data_root, one, "--epochs", "2", "--warmup_epochs", "1",
            "--save_frequency", "1", "--dist_url",
            f"file://{os.path.join(root, 'init_cli')}"))
    finally:
        td.init_process_group = init_group
        for k in launcher:
            os.environ.pop(k)
    got = counts()
    n = 2 * (CLI_TRAIN // CLI_BATCH)
    want = {k: v * n for k, v in PER_STEP_CLI.items()}
    if backends != ["nccl"] or dist.in_group():
        raise SystemExit(f"dp: the command line's group {backends}, still "
                         f"initialised after main: {dist.in_group()}")
    if {k: got[k] for k in want} != want:
        raise SystemExit(f"dp cli: launches {got}, expected {want}")
    two = os.path.join(cli_root, "two_epochs")
    log_a, log_b = read_log(one), read_log(two)
    a = torch.load(os.path.join(one, "checkpoint-1.pth"), weights_only=True)
    b = torch.load(os.path.join(two, "checkpoint-1.pth"), weights_only=True)
    same_w = all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    same_m = all(torch.equal(s["exp_avg"], b["optimizer"]["state"][k]
                             ["exp_avg"])
                 for k, s in a["optimizer"]["state"].items())
    print(f"dp (a) cli as rank 0 of 1 (--dist_url file://), backend "
          f"{backends[0]}: launches/step { {k: got[k] // n for k in want} }, "
          f"train_loss {[e['train_loss'] for e in log_a]} vs without a "
          f"group {[e['train_loss'] for e in log_b]}; weights bit-equal "
          f"{same_w}, exp_avg bit-equal {same_m}", flush=True)
    if not (log_a == log_b and same_w and same_m):
        raise SystemExit("dp (a): the one-rank nccl run differs from the run "
                         "without a group")
    report["one_rank"] = dict(backend=backends[0], log=log_a,
                              launches_per_step={k: got[k] // n
                                                 for k in want})

    # the all-reduce in the step: its calls a step, the device time of the
    # step with and without the group and of one reduction of the step's
    # gradients (profiler), and the step's ms with and without the group,
    # in the order off, on, on, off
    batches = load_batches(data_root, TRAIN_BATCH, 2048, split="train")
    low = torch.from_numpy(batches[0][0]["sample"]).to(dev)
    high = torch.from_numpy(batches[0][1]["sample"]).to(dev)

    def train_step():
        model = tulip_base(drop_path_rate=0.1, **FLAGSHIP)
        model.load_state_dict(weights, strict=True)
        model = model.to(dev)
        step = make_train_step(model, make_optimizer(model, 0.01),
                               compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(0)
        return model, lambda: step(low, high, 5e-4, gen)

    ms = {False: [], True: []}
    ms[False].append(timed_steps(torch, dev, weights, batches, 10, True))
    os.environ["TULIP_TPU_LN_PALLAS"] = "1"
    model, fn = train_step()
    step_us = {False: device_us(torch, fn, n=5)}
    del model, fn
    td.init_process_group("nccl", init_method=f"file://"
                          f"{os.path.join(root, 'init_step')}",
                          world_size=1, rank=0)
    try:
        ms[True].append(timed_steps(torch, dev, weights, batches, 10, True))
        ms[True].append(timed_steps(torch, dev, weights, batches, 10, True))
        os.environ["TULIP_TPU_LN_PALLAS"] = "1"
        model, fn = train_step()
        step_us[True] = device_us(torch, fn, n=5)
        calls, all_reduce = [], td.all_reduce
        td.all_reduce = lambda t, *a, **k: (calls.append(t.numel()),
                                            all_reduce(t, *a, **k))[1]
        try:
            fn()
        finally:
            td.all_reduce = all_reduce
        grads = [torch.randn_like(p) for p in model.parameters()]
        grads.append(torch.zeros(2, device=dev))   # the two losses
        buckets = len(list(dist._buckets(grads, dist.BUCKET_BYTES)))
        avg_us = device_us(torch, lambda: dist.average_(grads), n=10)
        del model, fn, grads
    finally:
        td.destroy_process_group()
    ms[False].append(timed_steps(torch, dev, weights, batches, 10, True))
    os.environ.pop("TULIP_TPU_LN_PALLAS", None)
    nccl = {k: v for k, v in step_us[True].items() if "nccl" in k.lower()}
    busy = {k: sum(v.values()) / 1e3 for k, v in step_us.items()}
    avg_ms = sum(avg_us.values()) / 1e3
    print(f"dp (a) train step, batch {TRAIN_BATCH}, bf16, "
          f"TULIP_TPU_LN_PALLAS=1: {len(calls)} all_reduce calls a step in "
          f"one rank's nccl group ({sum(calls) * 4 / 1e6:.1f} MB, {buckets} "
          f"buckets expected); device ms a step {busy[True]:.3f} under the "
          f"group, {busy[False]:.3f} without; NCCL kernels a step "
          f"{ {k: round(v, 2) for k, v in nccl.items()} } (us); one "
          f"average_ of the step's gradients {avg_ms:.4f} ms of device time "
          f"({ {k[:60]: round(v, 2) for k, v in avg_us.items()} } us); "
          f"median step ms of 8 timed steps, runs off, on, on, off: without "
          f"a group {ms[False][0]:.2f} / {ms[False][1]:.2f}, under the group "
          f"{ms[True][0]:.2f} / {ms[True][1]:.2f}", flush=True)
    if len(calls) != buckets:
        raise SystemExit(f"dp (a): {len(calls)} all_reduce calls a step, "
                         f"expected {buckets}")
    report["step"] = dict(all_reduce_calls=len(calls),
                          all_reduce_mb=sum(calls) * 4 / 1e6,
                          device_ms_group=busy[True],
                          device_ms_no_group=busy[False],
                          nccl_us=nccl, average_ms=avg_ms,
                          average_us_by_name=avg_us,
                          step_ms_no_group=ms[False], step_ms_group=ms[True])

    report["two_ranks"] = run_dp_ranks(
        torch, dev, weights, data_root, root, "gloo", [str(dev)] * 2,
        "(b) gloo, one card (host copies, not a multi-GPU time)")
    return report


# kernel-name substring -> class of the profile's summary line; a name that
# matches none is PyTorch's own
PROFILE_CLASSES = {
    "window_msa": "K1/K2 attention half-block (its sum pass included)",
    "two_matmul": "K3", "ln_linear_bwd": "K11 token pass (LN, dy, finish)",
    "ln_linear": "K4 (LN pass, product, sum pass)",
    "attn_fwd_tc": "K8 attention core forward (mma.sync)",
    "attn_bwd_tc": "K9 attention core backward (mma.sync)",
    "attn_": "K8/K9 FMA kernels", "mlp_bwd": "K10 token pass",
    "tn_gemm": "weight gradients", "colsum": "weight gradients",
    "ln_rows": "LN passes of K3 / K10", "ln_fwd": "K14 LayerNorm forward",
    "ln_bwd": "K15 LayerNorm backward",
    "tulip": "other kernels of the port"}


def profile_paths(torch, dev, tree):
    """``python3 chip_smoke.py --profile``: torch.profiler over the bf16
    inference forward (batch 1 and 8, 5 forwards each) and 3 bf16 train
    steps of batch 8, without and with TULIP_TPU_LN_PALLAS=1, all at the
    flagship size after a warm-up: per path
    the wall ms per iteration, the device's busy share and the device ms
    per iteration of every kernel name above 0.5 % (the port's kernels by
    their C++ names, the rest by PyTorch's; the attention half-block's
    kernels whatever their share) and the sums by PROFILE_CLASSES, then
    profile_attn, k3_plan_ab, profile_nn and profile_ln.  Also written to
    chiprun_out/profile.json, or with --tree DIR (the package at DIR) to
    chiprun_out/profile_<DIR's name>.json.  No check, no kernel table: the
    default run does those."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tulip_tpu_torch.models.tulip import apply_model, init_params, tulip_base
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step

    data_root = os.path.join(REPO, "build", "chip_smoke_durlar")
    write_durlar(data_root, 8, 2048)
    weights = init_params(tulip_base(**FLAGSHIP).cfg,
                          torch.Generator().manual_seed(0))
    report = {}

    def run(name, fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.self_device_time_total / iters / 1e3,
                        e.count / iters) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation
                       and e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"profile {name}: wall {wall:.2f} ms per iteration (not "
              f"profiled), device busy {busy:.2f} ms = "
              f"{100 * busy / wall:.1f} % of it, {sum(r[2] for r in rows):.0f}"
              f" kernel launches per iteration", flush=True)
        for key, ms, n in rows:
            if ms >= 0.005 * busy or "window_msa" in key:
                print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f} % x{n:<5.0f} "
                      f"{key[:100]}", flush=True)
        classes = dict.fromkeys([*PROFILE_CLASSES.values(), "PyTorch"], 0.0)
        for key, ms, n in rows:
            classes[next((c for sub, c in PROFILE_CLASSES.items()
                          if sub in key), "PyTorch")] += ms
        print(f"  by class, ms per iteration: "
              f"{ {c: round(ms, 3) for c, ms in classes.items() if ms} }",
              flush=True)
        report[name] = dict(wall_ms=wall, device_ms=busy, classes=classes,
                            kernels=[dict(name=k, ms=ms, launches=n)
                                     for k, ms, n in rows])

    model = tulip_base(**FLAGSHIP)
    model.load_state_dict(weights, strict=True)
    model = model.to(device=dev, dtype=torch.bfloat16)
    for bs in (1, 8):
        low, high = load_batches(data_root, bs, 2048)[0]
        x = torch.from_numpy(low["sample"]).to(dev)
        t = torch.from_numpy(high["sample"]).to(dev)
        run(f"forward batch {bs}",
            lambda: apply_model(model, x, t, compute_dtype=torch.bfloat16), 5)
    del model
    write_durlar(data_root, TRAIN_BATCH, 2048, split="train")
    low, high = load_batches(data_root, TRAIN_BATCH, 2048, split="train")[0]
    x = torch.from_numpy(low["sample"]).to(dev)
    t = torch.from_numpy(high["sample"]).to(dev)
    tm = tulip_base(drop_path_rate=0.1, **FLAGSHIP)
    tm.load_state_dict(weights, strict=True)
    tm = tm.to(dev)
    step = make_train_step(tm, make_optimizer(tm, 0.01),
                           compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    run(f"train step batch {TRAIN_BATCH}", lambda: step(x, t, 5e-4, gen), 3)
    # the same step with norm1 through the LayerNorm kernels (K14, K15)
    os.environ["TULIP_TPU_LN_PALLAS"] = "1"
    try:
        run(f"train step batch {TRAIN_BATCH} TULIP_TPU_LN_PALLAS=1",
            lambda: step(x, t, 5e-4, gen), 3)
    finally:
        os.environ.pop("TULIP_TPU_LN_PALLAS")
    del tm, step
    torch.cuda.empty_cache()
    report["attn"] = profile_attn(torch, dev)
    report["k3_plan"] = k3_plan_ab(torch, dev)
    report["nn"] = profile_nn(torch, dev, data_root, weights)
    report["ln"] = profile_ln(torch, dev)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = ("profile.json" if tree == "this checkout" else
            f"profile_{os.path.basename(os.path.normpath(tree))}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(report, f, indent=1)
    return 0


# K5's kernels by name -> class of its breakdown; PyTorch's kernels in a
# K5 call (the argsort, memsets) are plan glue
K5_CLASSES = {"nn2_box": "plan glue", "nn2_morton": "plan glue",
              "nn2_gather": "plan glue", "nn2_bound": "plan glue",
              "nn2_first_pass": "first pass", "nn2_ub": "first pass",
              "nn2_list": "compaction", "nn2_sweep": "sweep",
              "nn2_unsort": "unsort"}
# K6's (the same kernels in one direction; the first cut's h_kernel is its
# sweep, its torch glue its plan); PyTorch's kernels are plan
K6_CLASSES = {"nn2_bound": "bound", "nn2_list": "lists",
              "nn2_first_pass": "first pass", "nn2_ub": "first pass",
              "nn2_sweep": "sweep", "h_kernel": "sweep",
              "nn2_unsort": "unsort"}


def device_us(torch, fn, n=10):
    """{kernel name: device us per call of fn} by torch.profiler, the mean
    of n calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window whose events the tracer lost is rerun
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total / n
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation
              and e.self_device_time_total > 0}
        if us:
            return us
    raise SystemExit("the profiler recorded no device time")


def profile_attn(torch, dev):
    """K8 and K9 in bf16 at every shape of the batch-8 and batch-1 train
    steps, by torch.profiler: device us per call (mean of 10; K9 with its
    d(bias) column sum) beside the bound and F.scaled_dot_product_attention's
    device time, and the sums per train step (each shape's launches in a
    step)."""
    g = torch.Generator().manual_seed(1)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    rows, step = [], {}
    for batch in (TRAIN_BATCH, 1):
        for (H, W), C, nh in STAGES:
            for shifted in (False, True):
                for _, knum, label, kfn, _, _, extra in attn_core_cases(
                        torch, dev, rn, torch.bfloat16, batch, H, W, C, nh,
                        shifted, True, per_step=1 if C == 768 else 2):
                    kern = device_us(torch, kfn)
                    lib = sum(device_us(torch, extra["library"]).values())
                    bound = bound_ms(*extra["work"], "bfloat16")[0] * 1e3
                    total = sum(kern.values())
                    for key, v in ((knum, total), (knum + " bound", bound),
                                   (knum + " sdpa", lib)):
                        key = f"{key} batch {batch}"
                        step[key] = step.get(key, 0.0) + v * extra["per_step"]
                    rows.append(dict(label=label, device_us=total,
                                     kernels=kern, sdpa_us=lib,
                                     bound_us=bound))
                    print(f"profile {label}: device {total:.2f} us "
                          f"({100 * bound / total:.0f} % of the bound "
                          f"{bound:.2f}), sdpa {lib:.2f} us; "
                          + ", ".join(f"{k.split('(')[0][-28:]} {v:.2f}"
                                      for k, v in kern.items()), flush=True)
    print("profile K8 / K9 per train step, device us: "
          + ", ".join(f"{k} {v:.1f}" for k, v in step.items()), flush=True)
    return dict(rows=rows, per_step_us=step)


def profile_ln(torch, dev):
    """K14 and K15 in bf16 at the norm1 shapes of the batch-8 and batch-1
    train steps, by torch.profiler: device us per call (mean of 10; K15
    with every kernel it launches) beside F.layer_norm's and its
    backward's device time on the same tensors and the bound (work_ln),
    and the sums per train step (each shape's launches in a step: four at
    C 96, 192 and 384, two at C 768)."""
    g = torch.Generator().manual_seed(6)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    rows, step = [], {}
    for batch in (TRAIN_BATCH, 1):
        for (H, W), C, _ in STAGES:
            per_step = 2 if C == 768 else 4
            for _, knum, label, kfn, _, _, extra in ln_cases(
                    torch, dev, rn, torch.bfloat16, batch * H * W, C,
                    f" batch {batch}", True, per_step):
                kern = device_us(torch, kfn)
                lib = sum(device_us(torch, extra["library"]).values())
                bound = bound_ms(*extra["work"], "bfloat16")[0] * 1e3
                total = sum(kern.values())
                for key, v in ((knum, total), (knum + " bound", bound),
                               (knum + " library", lib)):
                    key = f"{key} batch {batch}"
                    step[key] = step.get(key, 0.0) + v * per_step
                rows.append(dict(label=label, device_us=total, kernels=kern,
                                 library_us=lib, bound_us=bound))
                print(f"profile {label}: device {total:.2f} us "
                      f"({100 * bound / total:.0f} % of the bound "
                      f"{bound:.2f}), library {lib:.2f} us; "
                      + ", ".join(f"{k.split('(')[0][-28:]} {v:.2f}"
                                  for k, v in kern.items()), flush=True)
    print("profile K14 / K15 per train step, device us: "
          + ", ".join(f"{k} {v:.1f}" for k, v in step.items()), flush=True)
    return dict(rows=rows, per_step_us=step)


def eval_clouds(torch, dev, data_root, weights):
    """Phase 6's clouds: sample 0's gated gt against the fp32 random-weight
    pred, projected as the metric step projects them; also the metric step
    and the forward's outputs it takes."""
    from tulip_tpu_torch.eval import engine as E
    from tulip_tpu_torch.eval.geometry import img_to_pcd_durlar_torch
    from tulip_tpu_torch.models.tulip import tulip_base
    model32 = tulip_base(**FLAGSHIP)
    model32.load_state_dict(weights, strict=True)
    model32 = model32.to(dev)
    low, high = load_batches(data_root, 1, 2048)[0]
    fwd = E._make_eval_forward(model32, "durlar", True, E._GATES,
                               torch.float32)
    metrics_fn = E._make_device_metrics("durlar", eval_args(os.path.join(
        REPO, "build", "chip_smoke_eval")), mc=False)
    with torch.no_grad():
        outs = fwd(torch.from_numpy(low["sample"]).to(dev),
                   torch.from_numpy(high["sample"]).to(dev))
        dm = metrics_fn(*outs[:3])
        gt = img_to_pcd_durlar_torch(dm["high_gated"])
        pred = img_to_pcd_durlar_torch(dm["pred_inj"])
    return gt, pred, metrics_fn, outs


def profile_nn(torch, dev, data_root, weights):
    """K5 and K6 on phase 3's scan and perturbed copy, on a cloud pair far
    apart (the scan against the scan scaled by 0.7, as a poor prediction
    is) and on phase 6's eval clouds, by torch.profiler: device ms per call
    (mean of 5) by kernel name and by class.  K5: plan glue (codes, the
    argsort, sorted clouds and boxes, the bound kernel), first pass (round
    0's sweep and the upper-bound kernels), compaction (the list kernels),
    sweep (rounds 1-3), unsort.  K6: plan (codes, the argsort, sorted
    clouds and boxes), bound, lists, first pass, sweep, unsort.  Also the
    per-round pair counts (where the wrapper keeps them) and the
    device-to-host copies a call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tulip_tpu_torch.ops import chamfer as C
    label, a, b, _, _ = chamfer_clouds(torch, dev)[0]
    gt, pred, _, _ = eval_clouds(torch, dev, data_root, weights)
    out = {}
    for name, x, y in ((label, a, b), ("scan vs the scan x 0.7", a, a * 0.7),
                       (f"eval clouds N=M={gt.shape[0]}", gt, pred)):
        for knum, fn, table, names in (
                ("K5", C.min_sq_dists_h2, K5_CLASSES,
                 ["plan glue", "first pass", "compaction", "sweep",
                  "unsort"]),
                ("K6", C.min_sq_dists_h, K6_CLASSES,
                 ["plan", "bound", "lists", "first pass", "sweep",
                  "unsort"])):
            for _ in range(2):
                fn(x, y, 1024)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn(x, y, 1024)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation
                      and e.self_device_time_total > 0]
            kernels = {e.key: e.self_device_time_total / 5 / 1e3
                       for e in events}
            dtoh = sum(e.count for e in events if "DtoH" in e.key) / 5
            classes = dict.fromkeys(names, 0.0)
            for key, ms in kernels.items():
                classes[next((c for sub, c in table.items() if sub in key),
                             names[0])] += ms
            total = sum(kernels.values())
            counts = getattr(fn, "last_counts", None)
            counts = None if counts is None else counts.tolist()[0::2]
            print(f"profile {knum} {name}: device {total:.4f} ms per call; "
                  f"by class { {c: round(ms, 4) for c, ms in classes.items()} }"
                  f"; pairs listed per round {counts}; device-to-host "
                  f"copies per call {dtoh:g}", flush=True)
            for key, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
                print(f"  {ms:8.4f} ms {key[:100]}", flush=True)
            out[f"{knum} {name}"] = dict(device_ms=total, classes=classes,
                                         kernels=kernels, listed=counts,
                                         dtoh_per_call=dtoh)
    return out


def k3_plan_ab(torch, dev):
    """The rule of ops/mlp.py:two_matmul_plan against its alternative, on
    the bf16 K3 shapes of batch 8 and 1: hidden slices short enough for two
    CTAs per SM (more splits, fp32 partial sums) or as long as one CTA's
    shared memory holds.  Timed in turns within this call (rule,
    alternative, alternative, rule); median ms of 10 calls each."""
    from tulip_tpu_torch.ops import mlp
    cases = [c for c in more_two_matmul_cases(torch, dev)
             if "bfloat16" in c[2] and c[5]]
    rule = mlp.SMEM_TWO_PER_SM
    turns = [("two CTAs per SM", rule), ("one CTA per SM", mlp.SMEM_MAX),
             ("one CTA per SM", mlp.SMEM_MAX), ("two CTAs per SM", rule)]
    out = []
    try:
        for name, budget in turns:
            mlp.SMEM_TWO_PER_SM = budget
            ms = [cuda_ms(torch, c[3], iters=10) for c in cases]
            out.append(dict(plan=name, ms=ms))
            print(f"K3 plan {name}: " + ", ".join(
                f"{c[2].split('bfloat16 ')[1]} {t:.4f}"
                for c, t in zip(cases, ms)) + f"; sum {sum(ms):.4f} ms",
                flush=True)
    finally:
        mlp.SMEM_TWO_PER_SM = rule
    return out


def time_paths(torch, dev, tree):
    """``python3 chip_smoke.py --paths [--tree DIR]``: the wall ms of the
    bf16 inference forward at batch 1, 4 and 8 (median and least of 40
    synchronised forwards, twice over), K5, K6 and the eval metric step
    (time_paths_nn) and the bf16 batch-8 train step (timed_steps, twice),
    at the flagship size, for the package of this
    checkout or of the checkout at DIR.  Two commits are compared inside
    one call, on one card and one host, in the order parent, change,
    change, parent: the host is shared, and its wall times differ by up to
    1.8x between calls."""
    from tulip_tpu_torch.models.tulip import apply_model, init_params, tulip_base
    data_root = os.path.join(REPO, "build", "chip_smoke_durlar")
    write_durlar(data_root, 8, 2048)
    write_durlar(data_root, 2 * TRAIN_BATCH, 2048, split="train")
    model = tulip_base(**FLAGSHIP)
    weights = init_params(model.cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(weights, strict=True)
    model = model.to(device=dev, dtype=torch.bfloat16)
    fwd = lambda x, t: apply_model(model, x, t, compute_dtype=torch.bfloat16)
    for _ in range(2):
        for bs in (1, 4, 8):
            low, high = load_batches(data_root, bs, 2048)[0]
            x = torch.from_numpy(low["sample"]).to(dev)
            t = torch.from_numpy(high["sample"]).to(dev)
            for _ in range(5):
                fwd(x, t)
            torch.cuda.synchronize()
            times = []
            for _ in range(40):
                t0 = time.perf_counter()
                fwd(x, t)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            print(f"paths {tree}: forward batch {bs} median {med * 1e3:.3f} "
                  f"ms = {bs / med:.2f} img/s (min {min(times) * 1e3:.3f} "
                  f"ms)", flush=True)
    del model
    time_paths_nn(torch, dev, tree, data_root, weights)
    batches = load_batches(data_root, TRAIN_BATCH, 2048, split="train")
    for _ in range(2):
        ms = timed_steps(torch, dev, weights, batches, 14, False)
        print(f"paths {tree}: train step batch {TRAIN_BATCH} median of 12 "
              f"{ms:.2f} ms", flush=True)
    return 0


def time_paths_nn(torch, dev, tree, data_root, weights):
    """Part of --paths: K5 (min_sq_dists_h2) and K6 (min_sq_dists_h) on
    phase 3's scan and perturbed copy and on phase 6's clouds (sample 0's
    gt against the fp32 random-weight pred), and phase 6's metric step on
    the same sample (median of 10 by CUDA events, twice over)."""
    from tulip_tpu_torch.ops import chamfer as C
    _, a, b, _, _ = chamfer_clouds(torch, dev)[0]
    gt, pred, metrics_fn, outs = eval_clouds(torch, dev, data_root, weights)
    with torch.no_grad():
        for _ in range(2):
            ms = {(k, c): cuda_ms(torch, lambda: fn(x, y, 1024), iters=10,
                                  warmup=2)
                  for k, fn in (("K5", C.min_sq_dists_h2),
                                ("K6", C.min_sq_dists_h))
                  for c, x, y in (("scan vs perturbed copy", a, b),
                                  ("eval clouds", gt, pred))}
            step = cuda_ms(torch, lambda: metrics_fn(*outs[:3]), iters=10,
                           warmup=2)
            print(f"paths {tree}: "
                  + ", ".join(f"{k} {c} {v:.4f} ms" for (k, c), v in
                              ms.items())
                  + f", eval metric step {step:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 11: the model variants beyond the flagship
# ---------------------------------------------------------------------------

# launches a forward / a train step: (a) Swin-v2 with the flagship heads,
# (b) v1 with the default heads, (c) TULIP-large with the flags of
# bash_scripts/tulip_upsampling_carla.sh
V2_PER_FORWARD = {"window_msa": 0, "ln_linear": 0, "two_matmul": 15,
                  "ln_fwd": 31}
V2_PER_STEP = {"window_msa": 0, "attn_core_fwd": 0, "attn_core_bwd": 0,
               "two_matmul": 15, "two_matmul_bwd": 15, "ln_linear": 0,
               "ln_linear_bwd": 0, "ln_fwd": 31, "ln_bwd": 31}
DEFAULT_HEADS_PER_FORWARD = {"window_msa": 14, "window_msa_many_heads": 6,
                             "two_matmul": 14, "ln_linear": 3, "ln_fwd": 5}
LARGE_PER_FORWARD = {"window_msa": 18, "window_msa_many_heads": 10,
                     "two_matmul": 19, "ln_linear": 4, "ln_fwd": 0}
LARGE_PER_STEP = {"window_msa": 0, "attn_core_fwd": 18, "attn_core_bwd": 18,
                  "two_matmul": 19, "two_matmul_bwd": 19, "ln_linear": 4,
                  "ln_linear_bwd": 4, "ln_fwd": 0, "ln_bwd": 0}
# the dropout model (0.1 / 0.1): the head's K3 alone, in "mc" and in a step
MC_PER_FORWARD = {"window_msa": 0, "two_matmul": 1, "ln_linear": 3,
                  "ln_fwd": 0}
DROPOUT_PER_STEP = {"window_msa": 0, "attn_core_fwd": 0, "attn_core_bwd": 0,
                    "two_matmul": 1, "two_matmul_bwd": 1, "ln_linear": 3,
                    "ln_linear_bwd": 3, "ln_fwd": 0, "ln_bwd": 0}
VARIANT_STEPS = 3


def _launch_check(name, got, want, n=1):
    per = {k: got[k] // n if n else got[k] for k in want}
    if any(got[k] != v * n for k, v in want.items()):
        raise SystemExit(f"{name}: launches {per} (x{n}), expected {want}")
    return per


def _variant_forwards(torch, name, model, data_root, want):
    """bf16 forwards at batch 1 and 8 through apply_model, counted one at
    a time; the median ms of 5 more.  Returns ({batch: ms}, batch-1
    input, its pred)."""
    from tulip_tpu_torch.models.tulip import apply_model
    dev = next(model.parameters()).device
    out, first = {}, None
    for bs in (1, 8):
        low, high = load_batches(data_root, bs, 2048)[0]
        x = torch.from_numpy(low["sample"]).to(dev)
        t = torch.from_numpy(high["sample"]).to(dev)
        reset_counts()
        pred, loss, _ = apply_model(model, x, t, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        per = _launch_check(f"{name} forward batch {bs}", counts(), want)
        if (tuple(pred.shape) != (bs, 1, 128, 2048)
                or not bool(torch.isfinite(pred).all())
                or not math.isfinite(loss.item())):
            raise SystemExit(f"{name}: bad pred at batch {bs}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            apply_model(model, x, t, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[bs] = statistics.median(times) * 1e3
        if bs == 1:
            first = (x, pred)
        print(f"variants {name}: bf16 forward batch {bs}: launches {per}, "
              f"median {out[bs]:.2f} ms (min {min(times) * 1e3:.2f})",
              flush=True)
    return out, first


def _against_cpu(torch, name, make, weights, x1, pred_bf16, fp32=True,
                 phase="variants"):
    """The batch-1 bf16 (and fp32) cuda preds against the fp32 CPU plain
    path on the same weights: 3e-2 / 1e-3 of max|ref|."""
    from tulip_tpu_torch.models.tulip import apply_model
    cpu = make()
    cpu.load_state_dict(weights, strict=True)
    ref = apply_model(cpu, x1.cpu(), mc_drop=True)
    errs = {"bf16": rel_err(torch, pred_bf16.cpu(), ref)}
    if fp32:
        m32 = make().to(x1.device)
        m32.load_state_dict(weights, strict=True)
        errs["fp32"] = rel_err(torch, apply_model(m32, x1, mc_drop=True).cpu(),
                               ref)
        del m32
    print(f"{phase} {name}: batch-1 pred vs the fp32 cpu plain path: "
          f"err/max|ref| {errs} (limits bf16 3e-2, fp32 1e-3)", flush=True)
    if errs["bf16"] > 3e-2 or errs.get("fp32", 0.0) > 1e-3:
        raise SystemExit(f"{phase} {name}: pred check failed")
    return errs


def _variant_steps(torch, dev, name, make, weights, data_root, want):
    """VARIANT_STEPS bf16 train steps at batch TRAIN_BATCH, drop-path 0.1
    drawn from a device generator, counted: finite losses, the launches
    a step, the median ms of the last two, peak memory."""
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    model = make(drop_path_rate=0.1).to(dev)
    model.load_state_dict(weights, strict=True)
    step = make_train_step(model, make_optimizer(model, 0.01),
                           compute_dtype=torch.bfloat16)
    low, high = load_batches(data_root, TRAIN_BATCH, 2048, split="train")[0]
    low = torch.from_numpy(low["sample"]).to(dev)
    high = torch.from_numpy(high["sample"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, times = [], []
    for _ in range(VARIANT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(low, high, 5e-4, gen)[0].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per = _launch_check(f"{name} train", counts(), want, VARIANT_STEPS)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"variants {name}: train losses {losses}")
    ms = statistics.median(times[1:]) * 1e3
    print(f"variants {name}: {VARIANT_STEPS} bf16 train steps of batch "
          f"{TRAIN_BATCH}, drop_path_rate 0.1: losses "
          f"{[round(v, 5) for v in losses]}, launches/step {per}, step "
          f"{ms:.2f} ms (first {times[0] * 1e3:.1f}), peak mem {peak:.0f} MiB",
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=ms, peak_mib=peak, launches=per)


def _v2_split(torch, model, x, t):
    """Device ms of the batch-8 bf16 v2 forward by class (K3, K14, the
    rest: PyTorch's ops), and of its 14 cosine attentions alone (PyTorch's
    ops), by torch.profiler."""
    from tulip_tpu_torch.models.tulip import apply_model
    from tulip_tpu_torch.models.swin import window_partition
    us = device_us(torch, lambda: apply_model(model, x, t,
                                              compute_dtype=torch.bfloat16),
                   n=3)
    split = {"K3": 0.0, "K14": 0.0, "PyTorch": 0.0}
    for k, v in us.items():
        cls = ("K3" if "two_matmul" in k or "ln_rows" in k else
               "K14" if "ln_fwd" in k else "PyTorch")
        split[cls] += v / 1e3
    calls = []
    for stages in (model.layers, model.layers_up):
        for stage in stages:
            for blk in stage.blocks:
                H, W = blk.st.grid
                C = blk.attn.proj.weight.shape[0]
                xw = window_partition(torch.randn(
                    x.shape[0], H, W, C, device=x.device,
                    dtype=torch.bfloat16), *blk.st.window)
                mask = (None if blk.attn_mask is None
                        else blk.attn_mask.float())
                calls.append((blk.attn, xw, mask))

    def attention():
        with torch.no_grad():
            for attn, xw, mask in calls:
                attn(xw, mask)

    attn_ms = sum(device_us(torch, attention, n=3).values()) / 1e3
    split["cosine attention (PyTorch ops, alone)"] = attn_ms
    print(f"variants v2: device ms of the batch-8 bf16 forward by class "
          f"{ {k: round(v, 3) for k, v in split.items()} }", flush=True)
    return split


def run_variants_phase(torch, dev, data_root, cli_data_root):
    """Phase 11: the model variants at full width (DurLAR 32x2048 ->
    128x2048, random weights from seeded generators), every run with the
    counts set to 0 just before it and read just after."""
    import shutil
    from tulip_tpu_torch.eval import engine as E
    from tulip_tpu_torch.models.tulip import (apply_model, init_params,
                                              tulip_base, tulip_large)
    from tulip_tpu_torch.utils.writer import TBWriter
    t_phase = time.perf_counter()
    report = {}
    bf16 = torch.bfloat16

    def maker(factory, **kw):
        return lambda **more: factory(**dict(FLAGSHIP, **kw, **more))

    def loaded(make, weights, device, dtype=torch.float32, **kw):
        m = make(**kw)
        m.load_state_dict(weights, strict=True)
        return m.to(device=device, dtype=dtype)

    def on_card(make, weights):
        return loaded(make, weights, dev, bf16)

    # -- (a) Swin-v2 with the flagship heads -------------------------------
    make = maker(tulip_base, swin_v2=True)
    weights = init_params(make().cfg, torch.Generator().manual_seed(1))
    model = on_card(make, weights)
    ms, (x1, p1) = _variant_forwards(torch, "v2", model, data_root,
                                     V2_PER_FORWARD)
    errs = _against_cpu(torch, "v2", make, weights, x1, p1)
    low, high = load_batches(data_root, 8, 2048)[0]
    split = _v2_split(torch, model, torch.from_numpy(low["sample"]).to(dev),
                      torch.from_numpy(high["sample"]).to(dev))
    del model
    steps = _variant_steps(torch, dev, "v2", make, weights, data_root,
                           V2_PER_STEP)
    t1 = torch.from_numpy(load_batches(data_root, 1, 2048)[0][1]["sample"])
    cpu = torch.device("cpu")
    ref = train_grads(torch, loaded(make, weights, cpu, drop_path_rate=0.0),
                      x1.cpu(), t1, torch.float32)
    got32 = train_grads(torch, loaded(make, weights, dev, drop_path_rate=0.0),
                        x1, t1.to(dev), torch.float32)
    got16 = train_grads(torch, loaded(make, weights, dev, drop_path_rate=0.0),
                        x1, t1.to(dev), bf16)
    rel32, gerrs, cos32 = grad_check(torch, got32, ref)
    rel16, _, cos16 = grad_check(torch, got16, ref)
    worst = max(gerrs, key=gerrs.get)
    print(f"variants v2: whole step batch 1 vs the fp32 cpu plain path: "
          f"fp32 loss rel {rel32:.2e} (limit 1e-4), worst gradient {worst} "
          f"{gerrs[worst]:.2e} (limit 1e-3); bf16 loss rel {rel16:.2e} "
          f"(limit 3e-2), cosine {cos16:.5f} (limit 0.99)", flush=True)
    if not (rel32 <= 1e-4 and gerrs[worst] <= 1e-3 and rel16 <= 3e-2
            and cos16 >= 0.99):
        raise SystemExit("variants v2: whole-step check failed")
    report["v2"] = dict(forward_ms=ms, pred_err=errs, split_ms=split,
                        train=steps, whole_step=dict(
                            loss_rel_fp32=rel32, worst_grad=worst,
                            worst_grad_err=gerrs[worst], cos_fp32=cos32,
                            loss_rel_bf16=rel16, cos_bf16=cos16))

    # -- (b) v1 blocks with the default heads ------------------------------
    make = maker(tulip_base, pixel_shuffle=False, patch_unmerging=False)
    weights = init_params(make().cfg, torch.Generator().manual_seed(2))
    model = on_card(make, weights)
    low = torch.from_numpy(load_batches(data_root, 1, 2048)[0][0]["sample"])
    reset_counts()
    pred = apply_model(model, low.to(dev), mc_drop=True, compute_dtype=bf16)
    torch.cuda.synchronize()
    per = _launch_check("default heads forward", counts(),
                        DEFAULT_HEADS_PER_FORWARD)
    print(f"variants default heads: bf16 forward batch 1: launches {per}",
          flush=True)
    report["default_heads"] = dict(launches=per, pred_err=_against_cpu(
        torch, "default heads", make, weights, low.to(dev), pred))
    del model

    # -- (c) TULIP-large, the flags of tulip_upsampling_carla.sh -----------
    make = maker(tulip_large)
    weights = init_params(make().cfg, torch.Generator().manual_seed(3))
    model = on_card(make, weights)
    ms, (x1, p1) = _variant_forwards(torch, "TULIP-large", model, data_root,
                                     LARGE_PER_FORWARD)
    del model
    report["tulip_large"] = dict(
        forward_ms=ms,
        pred_err=_against_cpu(torch, "TULIP-large", make, weights, x1, p1,
                              fp32=False),
        train=_variant_steps(torch, dev, "TULIP-large", make, weights,
                             data_root, LARGE_PER_STEP))

    # -- (d) dropout 0.1 / 0.1 on the flagship ------------------------------
    out_dir = os.path.join(REPO, "build", "chip_smoke_variants")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    writer = TBWriter(os.path.join(out_dir, "tb"))
    samples = load_batches(data_root, 1, 2048)[:NUM_EVAL]
    weights = init_params(tulip_base(**FLAGSHIP).cfg,
                          torch.Generator().manual_seed(4))
    drop = on_card(maker(tulip_base, drop_rate=0.1, attn_drop_rate=0.1),
                   weights)
    plain = on_card(maker(tulip_base), weights)
    chunks = []
    make_mc = E._make_mc_forward

    def recording(*a, **k):
        fwd = make_mc(*a, **k)

        def run(x, generator=None):
            out = fwd(x, generator)
            if len(chunks) < 7:      # sample 1's ceil(50 / 8) chunks
                chunks.append(out)
            return out
        return run

    texts, mc_counts = [], None
    for i in range(2):
        E._make_mc_forward = recording
        reset_counts()
        E.MCdrop(samples, drop, writer, args=eval_args(out_dir), device=dev,
                 compute_dtype=bf16)
        torch.cuda.synchronize()
        got = counts()
        E._make_mc_forward = make_mc
        n_fwd = NUM_EVAL * math.ceil(50 / 8)
        mc_counts = _launch_check("dropout MCdrop", got, MC_PER_FORWARD,
                                  n_fwd)
        with open(os.path.join(out_dir, "results_mcdrop.txt"), "rb") as f:
            texts.append(f.read())
        if i == 0:
            preds = torch.cat(chunks)[:50].float()
            std = preds.std(0, correction=1)
            differ = not torch.equal(preds[0], preds[1])
            removed = float((std > 0.0005 * preds.mean(0)).float().mean())
            first = [c.clone() for c in chunks]
            chunks.clear()
    same_draws = all(torch.equal(a, b) for a, b in zip(first, chunks))
    print(f"variants dropout: MCdrop 50 iterations on {NUM_EVAL} scans, "
          f"bf16, drop / attn_drop 0.1: launches/forward {mc_counts}, "
          f"iterations differ {differ}, pred_std max {float(std.max()):.4g}, "
          f"share of pixels removed {removed:.4f}; second run: the same "
          f"draws {same_draws}, results_mcdrop.txt equal "
          f"{texts[0] == texts[1]}", flush=True)
    if not (differ and float(std.max()) > 0 and same_draws
            and texts[0] == texts[1]):
        raise SystemExit("variants dropout: MCdrop check failed")
    results = []
    for m in (drop, plain):
        E.evaluate(samples, m, writer, args=eval_args(out_dir), device=dev,
                   compute_dtype=bf16)
        with open(os.path.join(out_dir, "results.txt"), "rb") as f:
            results.append(f.read())
    print(f"variants dropout: evaluate equals the rate-0 model's bit for "
          f"bit: {results[0] == results[1]}", flush=True)
    if results[0] != results[1]:
        raise SystemExit("variants dropout: evaluate differs from rate 0")
    del drop, plain
    report["dropout"] = dict(
        mc_launches_per_forward=mc_counts, pred_std_max=float(std.max()),
        removed_share=removed,
        train=_variant_steps(
            torch, dev, "dropout", maker(tulip_base, drop_rate=0.1,
                                         attn_drop_rate=0.1), weights,
            data_root, DROPOUT_PER_STEP))

    # -- (e) the command line: --swin_v2 without the head flags ------------
    cli_dir = os.path.join(out_dir, "cli")
    flags = [f for f in cli_flags(cli_data_root, cli_dir, "--epochs", "1",
                                  "--warmup_epochs", "1", "--save_frequency",
                                  "1", "--swin_v2")
             if f not in ("--pixel_shuffle", "--patch_unmerging")]
    reset_counts()
    run_cli_train(flags)
    got = counts()
    log = read_log(cli_dir)
    steps = CLI_TRAIN // CLI_BATCH
    per = _launch_check("cli --swin_v2 train", got,
                        {"window_msa": 0, "attn_core_fwd": 0,
                         "two_matmul_bwd": 14}, steps)
    text, code = run_cli([f for f in cli_flags(
        cli_data_root, os.path.join(cli_dir, "checkpoint-0.pth"), "--eval",
        "--swin_v2", log_dir=cli_dir)
        if f not in ("--pixel_shuffle", "--patch_unmerging")])
    with open(os.path.join(cli_dir, "results.txt")) as f:
        res = json.load(f)
    ok = (code == 0 and len(log) == 1 and math.isfinite(log[0]["train_loss"])
          and sorted(res) == RESULT_KEYS
          and all(math.isfinite(v) for k in res for v in res[k])
          and len(res["mae"]) == CLI_VAL)
    print(f"variants cli --swin_v2, default heads: one epoch ({steps} steps, "
          f"launches/step {per}), train_loss {log[0]['train_loss']:.5f}; "
          f"--eval exit {code}, results.txt {len(res['mae'])} scans, "
          f"mae {res['mae']}", flush=True)
    if not ok:
        raise SystemExit(f"variants cli failed:\n{text[-3000:]}")
    report["cli"] = dict(train_loss=log[0]["train_loss"], results=res)

    report["seconds"] = time.perf_counter() - t_phase
    print(f"variants: phase 11 took {report['seconds']:.1f} s", flush=True)
    return report


def variants_only(torch, dev) -> int:
    """``python3 chip_smoke.py --variants``: phase 11 alone, on the folders
    phases 4, 7 and 8 write (written here); no kernel table."""
    data_root = os.path.join(REPO, "build", "chip_smoke_durlar")
    write_durlar(data_root, 8, 2048)
    write_durlar(data_root, 2 * TRAIN_BATCH, 2048, split="train")
    cli_root = os.path.join(REPO, "build", "chip_smoke_cli", "durlar")
    write_durlar(cli_root, CLI_TRAIN, 2048, split="train")
    write_durlar(cli_root, CLI_VAL, 2048, split="val")
    report = run_variants_phase(torch, dev, data_root, cli_root)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


# ---------------------------------------------------------------------------
# phase 13: the Swin-v2 classifier at SwinV2-T width; TULIP with in_chans 2
# and with a bias-free qkv
# ---------------------------------------------------------------------------

# SwinV2-T, the JAX package's build_swin_v2 defaults (224 x 224, patch 4,
# C 96, depths 2 / 2 / 6 / 2, window 7): (grid, C, heads) of its stages
CLS_STAGES = [((56, 56), 96, 3), ((28, 28), 192, 6), ((14, 14), 384, 12),
              ((7, 7), 768, 24)]
CLS_BATCHES = (1, 128)   # 128: the reference Swin config's eval batch
# a classifier forward: K3 in each of the 12 blocks' MLP; K14 in the
# patch embed's norm, the blocks' 24 post-norms, the 3 merges' norms and
# the final norm
CLS_PER_FORWARD = {"window_msa": 0, "window_msa_many_heads": 0,
                   "ln_linear": 0, "two_matmul": 12, "ln_fwd": 29}
# TULIP at the flagship geometry, --in_chans 2 with the pixel-shuffle head
# (K3's folded head at O = 32) and with a bias-free v1 qkv; with the
# default heads, --in_chans 2 launches what phase 11 (b) does
FLAGSHIP_PER_FORWARD = {"window_msa": 14, "window_msa_many_heads": 6,
                        "two_matmul": 15, "ln_linear": 3, "ln_fwd": 0}


def classifier_kernel_cases(torch, device):
    """K3 (the v2 MLP: no LN prologue, GELU, no residual; C 96 / 192 / 384
    / 768, Hd 4C) and K14 (the norms) at the classifier's token counts
    (batch x 3,136 / 784 / 196 / 49) for batch 1 and 128, in bf16 and fp32,
    and K3 at the flagship's folded head with in_chans 2 (O = 32) at batch
    1.  Off the kernels line's path sums."""
    from tulip_tpu_torch.ops import mlp
    g = torch.Generator().manual_seed(13)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        to = lambda t: t.to(device=device, dtype=dtype)
        e = 2 if dtype == torch.bfloat16 else 4
        for batch in CLS_BATCHES:
            for (H, W), C, _ in CLS_STAGES:
                N = batch * H * W
                x = to(rn(N, C))
                args = [None, None, to(rn(4 * C, C, scale=C ** -0.5)),
                        to(rn(4 * C, scale=0.1)),
                        to(rn(C, 4 * C, scale=(4 * C) ** -0.5)),
                        to(rn(C, scale=0.1))]
                kw = dict(act="gelu", residual=False)
                nbytes, flops = work_two_matmul(N, C, 4 * C, C, e)
                cases.append((
                    "two_matmul", "K3",
                    f"two_matmul K3 {dn} classifier batch {batch} N={N} "
                    f"C={C} Hd={4 * C}",
                    lambda x=x, a=args: mlp.fused_two_matmul(x, *a, **kw),
                    lambda x=x, a=args: mlp.fused_two_matmul_ref(x, *a,
                                                                 **kw),
                    False, dict(work=(nbytes - 2 * C * e, flops))))
                cases += [c for c in ln_cases(
                    torch, device, rn, dtype, N, C,
                    f" classifier batch {batch}", False)
                    if c[0] == "ln_fwd"]
        N, C, c_out = 32 * 512, 96, 2
        rows = torch.arange(C * 16)
        w2 = torch.zeros(c_out, 16, C * 16)
        w2[:, rows % 16, rows] = rn(c_out, C, scale=C ** -0.5
                                    ).repeat_interleave(16, dim=1)
        x = to(rn(N, C))
        args = [to(rn(C, scale=0.1, shift=1.0)), to(rn(C, scale=0.1)),
                to(rn(16 * C, C, scale=C ** -0.5)), to(rn(16 * C, scale=0.1)),
                to(w2.reshape(c_out * 16, C * 16)), None]
        hk = dict(act="leaky", residual=False)
        cases.append((
            "two_matmul", "K3",
            f"two_matmul K3 {dn} head in_chans 2 N={N} C={C} Hd={16 * C} "
            f"O=32", lambda x=x, a=args: mlp.fused_two_matmul(x, *a, **hk),
            lambda x=x, a=args: mlp.fused_two_matmul_ref(x, *a, **hk), False,
            dict(work=work_two_matmul(N, C, 16 * C, 32, e))))
    return cases


def _classifier_split(torch, model, x):
    """Device ms of the bf16 classifier forward by class (K3, K14, the
    rest: PyTorch's ops) and of its 12 cosine attentions alone (PyTorch's
    ops), by torch.profiler."""
    from tulip_tpu_torch.models.swin import window_partition
    with torch.no_grad():
        us = device_us(torch, lambda: model(x), n=3)
    split = {"K3": 0.0, "K14": 0.0, "PyTorch": 0.0}
    for k, v in us.items():
        cls = ("K3" if "two_matmul" in k or "ln_rows" in k else
               "K14" if "ln_fwd" in k else "PyTorch")
        split[cls] += v / 1e3
    calls = []
    for stage in model.layers:
        for blk in stage.blocks:
            H, W = blk.st.grid
            C = blk.attn.proj.weight.shape[0]
            xw = window_partition(torch.randn(
                x.shape[0], H, W, C, device=x.device, dtype=x.dtype),
                *blk.st.window)
            mask = None if blk.attn_mask is None else blk.attn_mask.float()
            calls.append((blk.attn, xw, mask))

    def attention():
        with torch.no_grad():
            for attn, xw, mask in calls:
                attn(xw, mask)

    split["cosine attention (PyTorch ops, alone)"] = sum(
        device_us(torch, attention, n=3).values()) / 1e3
    total = split["K3"] + split["K14"] + split["PyTorch"]
    split["cosine attention share"] = (
        split["cosine attention (PyTorch ops, alone)"] / total)
    print(f"classifier: device ms of the batch-{x.shape[0]} bf16 forward by "
          f"class { {k: round(v, 4) for k, v in split.items()} } (total "
          f"{total:.3f} ms)", flush=True)
    return split


def _tulip_form(torch, dev, name, make, weights, x1, want, t1=None):
    """One TULIP form at the flagship geometry, batch 1: the bf16 forward
    counted (the counts set to 0 just before it), its pred against the
    fp32 CPU plain path (bf16 3e-2, fp32 1e-3 of max|ref|); with a target
    ``t1`` also one bf16 train step through make_train_step, counted, and
    the whole step against the CPU as phase 7 holds it."""
    from tulip_tpu_torch.models.tulip import apply_model
    from tulip_tpu_torch.train.step import make_optimizer, make_train_step
    model = make().to(dev)
    model.load_state_dict(weights, strict=True)
    model = model.to(torch.bfloat16)
    reset_counts()
    pred = apply_model(model, x1, mc_drop=True, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    per = _launch_check(f"{name} forward", counts(), want)
    H, W = FLAGSHIP["target_img_size"]
    if tuple(pred.shape) != (1, x1.shape[1], H, W):
        raise SystemExit(f"{name}: pred shape {tuple(pred.shape)}")
    print(f"tulip {name}: bf16 forward batch 1: pred {tuple(pred.shape)}, "
          f"launches {per}", flush=True)
    del model
    out = dict(launches=per, pred_err=_against_cpu(
        torch, name, make, weights, x1, pred, phase="tulip"))
    if t1 is None:
        return out
    model = make().to(dev)
    model.load_state_dict(weights, strict=True)
    step = make_train_step(model, make_optimizer(model, 0.01),
                           compute_dtype=torch.bfloat16)
    reset_counts()
    loss = step(x1, t1, 5e-4)[0].item()
    torch.cuda.synchronize()
    out["step_launches"] = _launch_check(f"{name} train step", counts(),
                                         PER_STEP)
    if not math.isfinite(loss):
        raise SystemExit(f"{name}: train loss {loss}")
    del model, step
    cpu = torch.device("cpu")

    def loaded(device):
        m = make().to(device)
        m.load_state_dict(weights, strict=True)
        return m

    ref = train_grads(torch, loaded(cpu), x1.cpu(), t1.cpu(), torch.float32)
    got32 = train_grads(torch, loaded(dev), x1, t1, torch.float32)
    got16 = train_grads(torch, loaded(dev), x1, t1, torch.bfloat16)
    rel32, gerrs, _ = grad_check(torch, got32, ref)
    rel16, _, cos16 = grad_check(torch, got16, ref)
    worst = max(gerrs, key=gerrs.get)
    print(f"tulip {name}: one bf16 train step (loss {loss:.5f}, launches "
          f"{out['step_launches']}); whole step batch 1 vs the fp32 cpu "
          f"plain path: fp32 loss rel {rel32:.2e} (limit 1e-4), worst "
          f"gradient {worst} {gerrs[worst]:.2e} (limit 1e-3); bf16 loss rel "
          f"{rel16:.2e} (limit 3e-2), cosine {cos16:.5f} (limit 0.99)",
          flush=True)
    if not (rel32 <= 1e-4 and gerrs[worst] <= 1e-3 and rel16 <= 3e-2
            and cos16 >= 0.99):
        raise SystemExit(f"tulip {name}: whole-step check failed")
    out["whole_step"] = dict(loss=loss, loss_rel_fp32=rel32,
                             worst_grad=worst, worst_grad_err=gerrs[worst],
                             loss_rel_bf16=rel16, cos_bf16=cos16)
    return out


def run_classifier_phase(torch, dev, data_root):
    """Phase 13: (a) the SwinV2-T classifier at full width, random weights
    from a seeded generator, bf16 forwards at batch 1 and 128 (the counts
    set to 0 just before each and read just after); (b) its batch-1 logits
    against the CPU; (c) K3 and K14 at its shapes; (d) TULIP with
    --in_chans 2 (both heads) and with a bias-free qkv (v1, forward and
    step) at the flagship geometry against the CPU; (e) the batch-128
    forward's device ms by class."""
    import dataclasses
    from tulip_tpu_torch.config import model_config
    from tulip_tpu_torch.models.swin_v2_classifier import (
        build_swin_v2, init_swin_v2_params)
    from tulip_tpu_torch.models.tulip import TULIP, init_params
    t_phase = time.perf_counter()
    report = {}
    bf16 = torch.bfloat16

    # -- (a) SwinV2-T, bf16, batch 1 and 128 --------------------------------
    model = build_swin_v2(device=dev)
    weights = init_swin_v2_params(model, torch.Generator().manual_seed(16))
    model.load_state_dict(weights, strict=True)
    model = model.to(bf16)
    g = torch.Generator().manual_seed(17)
    xs = {b: torch.randn(b, 3, 224, 224, generator=g) for b in CLS_BATCHES}
    fwd = {}
    for bs in CLS_BATCHES:
        x = xs[bs].to(dev, bf16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with torch.no_grad():
            logits = model(x)
        torch.cuda.synchronize()
        per = _launch_check(f"classifier forward batch {bs}", counts(),
                            CLS_PER_FORWARD)
        if (tuple(logits.shape) != (bs, 1000) or logits.dtype != bf16
                or not bool(torch.isfinite(logits).all())):
            raise SystemExit(f"classifier: bad logits at batch {bs}")
        times = []
        with torch.no_grad():
            for _ in range(2):
                model(x)
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        fwd[bs] = dict(launches=per, ms=med * 1e3, img_per_s=bs / med,
                       min_ms=min(times) * 1e3, peak_mib=peak)
        if bs == 1:
            first = logits
        print(f"classifier SwinV2-T 224x224: bf16 forward batch {bs}: logits "
              f"{tuple(logits.shape)} finite, launches {per}, median "
              f"{med * 1e3:.2f} ms = {bs / med:.1f} img/s (min "
              f"{min(times) * 1e3:.2f} ms), peak mem {peak:.0f} MiB",
              flush=True)
    report["forward"] = fwd

    # -- (b) batch-1 logits against the fp32 CPU plain path -----------------
    cpu = build_swin_v2(device="cpu")
    cpu.load_state_dict(weights, strict=True)
    with torch.no_grad():
        ref = cpu(xs[1])
        m32 = build_swin_v2(device=dev)
        m32.load_state_dict(weights, strict=True)
        errs = {"bf16": rel_err(torch, first.cpu(), ref),
                "fp32": rel_err(torch, m32(xs[1].to(dev)).cpu(), ref)}
    del m32, cpu
    print(f"classifier: batch-1 logits vs the fp32 cpu plain path: "
          f"err/max|ref| {errs} (limits bf16 3e-2, fp32 1e-3)", flush=True)
    if errs["bf16"] > 3e-2 or errs["fp32"] > 1e-3:
        raise SystemExit("classifier: logits check failed")
    report["logits_err"] = errs

    # -- (e) the batch-128 forward's device time by class -------------------
    report["split_ms"] = _classifier_split(
        torch, model, xs[CLS_BATCHES[-1]].to(dev, bf16))
    del model
    torch.cuda.empty_cache()

    # -- (c) K3 and K14 at the classifier's shapes --------------------------
    cases = classifier_kernel_cases(torch, dev)
    table = check_kernel_cases(torch, [c + (5,) for c in cases])
    check_deterministic(torch, dev, cases)
    del cases
    bad = [r["label"] for r in table if not r["ok"]]
    if bad:
        raise SystemExit(f"classifier kernels disagree: {bad}")
    report["table"] = table

    # -- (d) TULIP: --in_chans 2 (both heads), a bias-free qkv --------------
    low, high = load_batches(data_root, 1, FLAGSHIP["img_size"][1])[0]
    x1 = torch.from_numpy(low["sample"]).to(dev)
    t1 = torch.from_numpy(high["sample"]).to(dev)
    second = torch.rand(x1.shape, generator=torch.Generator().manual_seed(18))
    x2 = torch.cat([x1, second.to(dev)], dim=1)
    forms = (
        ("in_chans 2, pixel-shuffle head", dict(in_chans=2), True, x2,
         FLAGSHIP_PER_FORWARD, None),
        ("in_chans 2, default heads", dict(in_chans=2, pixel_shuffle=False,
                                           patch_unmerging=False), True, x2,
         DEFAULT_HEADS_PER_FORWARD, None),
        ("qkv_bias False, v1", {}, False, x1, FLAGSHIP_PER_FORWARD, t1))
    report["tulip"] = {}
    for i, (name, kw, qkv_bias, x, want, t) in enumerate(forms):
        cfg = dataclasses.replace(
            model_config("tulip_base", drop_path_rate=0.0,
                         **dict(FLAGSHIP, **kw)), qkv_bias=qkv_bias)
        make = lambda cfg=cfg: TULIP(cfg)
        weights = init_params(cfg, torch.Generator().manual_seed(20 + i))
        report["tulip"][name] = _tulip_form(torch, dev, name, make, weights,
                                            x, want, t)
        torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_phase
    print(f"classifier: phase 13 took {report['seconds']:.1f} s", flush=True)
    return report


def classifier_only(torch, dev) -> int:
    """``python3 chip_smoke.py --classifier``: phase 13 alone, on a folder
    as phase 4 writes it (written here); no kernels line."""
    data_root = os.path.join(REPO, "build", "chip_smoke_durlar")
    write_durlar(data_root, 8, 2048)
    report = run_classifier_phase(torch, dev, data_root)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "classifier.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


def main() -> int:
    import torch
    if "--dp-rank" in sys.argv[1:]:
        i = sys.argv.index("--dp-rank")
        return dp_rank_main(int(sys.argv[i + 1]), sys.argv[i + 2])
    if sys.argv[1:2] == ["--cli-rates"]:
        return cli_with_rates(float(sys.argv[2]), float(sys.argv[3]),
                              sys.argv[4:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = "this checkout"
    if "--tree" in sys.argv[1:]:
        # the package of another checkout (a parent commit's), not this one's
        tree = sys.argv[sys.argv.index("--tree") + 1]
        sys.path.insert(0, os.path.abspath(tree))
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
    if "--profile" in sys.argv[1:]:
        build.load()
        return profile_paths(torch, dev, tree)
    if "--paths" in sys.argv[1:]:
        build.load()
        return time_paths(torch, dev, tree)
    if "--ranks" in sys.argv[1:]:
        build.load()
        n = int(sys.argv[sys.argv.index("--ranks") + 1])
        if "--drift" in sys.argv[1:]:
            return run_drift_check(torch, n)
        return run_ranks_check(torch, n)
    if "--variants" in sys.argv[1:]:
        build.load()
        return variants_only(torch, dev)
    if "--sp" in sys.argv[1:]:
        build.load()
        return sp_only(torch, dev)
    if "--data" in sys.argv[1:]:
        build.load()
        return data_only(torch, dev)
    if "--classifier" in sys.argv[1:]:
        build.load()
        return classifier_only(torch, dev)

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
    hgmma, hmma, wide = sass_counts(build)
    hgmma = {k: hgmma[k] for k in TENSOR_CORE_KERNELS}
    hmma = {k: hmma[k] for k in MMA_SYNC_KERNELS}
    print(f"build: tensor-core instructions in the bf16 kernels: HGMMA "
          f"{hgmma}, HMMA (mma.sync) {hmma}; 128-bit global loads / stores "
          f"(LDG.E.128 / STG.E.128) of the bf16 LayerNorm kernels {wide}",
          flush=True)
    if not all(hgmma.values()):
        raise SystemExit(f"a bf16 tensor-core kernel holds no HGMMA: {hgmma}")
    if not all(hmma.values()):
        raise SystemExit(f"a bf16 mma.sync kernel holds no HMMA: {hmma}")
    if not all(n > 0 for pair in wide.values() for n in pair):
        raise SystemExit(f"a bf16 LayerNorm kernel lacks 128-bit global "
                         f"loads or stores: {wide}")

    # -- 3. kernels vs plain ----------------------------------------------
    cases = kernel_cases(torch, dev)
    table = check_kernel_cases(torch, [c + (10,) for c in cases])
    more = more_two_matmul_cases(torch, dev)
    more += more_window_msa_cases(torch, dev)
    more += more_ln_linear_cases(torch, dev)
    table += check_kernel_cases(torch, [c + (10,) for c in more])
    train_cases = train_kernel_cases(torch, dev)
    train_cases += more_attn_core_cases(torch, dev)
    table += check_kernel_cases(torch, [c + (5,) for c in train_cases])
    layouts = layout_and_ln_cases(torch, dev)
    layouts += layout_and_ln_cases(torch, dev, batch=8, layouts_only=True)
    layouts += more_ln_cases(torch, dev)
    table += check_kernel_cases(torch, [c + (10,) for c in layouts])
    check_ln_launches(torch, dev)
    check_deterministic(torch, dev, cases + more + train_cases + layouts)
    del cases, more, train_cases, layouts
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
    table += eval_report.pop("nn_rows")

    # -- 7. training -------------------------------------------------------
    del model, model32, cpu_model
    torch.cuda.empty_cache()
    train_report = run_train_phase(torch, dev, data_root, weights)

    # -- 8. the command line -------------------------------------------------
    torch.cuda.empty_cache()
    cli_report = run_cli_phase(torch, dev, weights)

    # -- 9. data parallel ----------------------------------------------------
    torch.cuda.empty_cache()
    dp_report = run_dp_phase(torch, dev, weights)

    # -- 10. W-axis sequence parallel ---------------------------------------
    torch.cuda.empty_cache()
    sp_report = run_sp_phase(torch, dev, weights)

    # -- 11. the model variants ---------------------------------------------
    torch.cuda.empty_cache()
    variants_report = run_variants_phase(
        torch, dev, data_root,
        os.path.join(REPO, "build", "chip_smoke_cli", "durlar"))

    # -- 12. the data path ---------------------------------------------------
    torch.cuda.empty_cache()
    data_report = run_data_phase(torch, dev, weights, throughput[8])

    # -- 13. the classifier, in_chans 2, a bias-free qkv --------------------
    torch.cuda.empty_cache()
    classifier_report = run_classifier_phase(torch, dev, data_root)

    # -- summary -----------------------------------------------------------
    # per kernel: the sums over its bf16 (chamfer: fp32) cases on the path
    kernels = []
    for kernel, (src, knums) in SOURCES.items():
        for knum, replaces in knums.items():
            dtype = "float32" if kernel.startswith("nn_") else "bfloat16"
            rows = [r for r in table if r["knum"] == knum
                    and r["dtype"] == dtype and r["on_path"]]
            n = (eval_report["launches"] if kernel.startswith("nn_")
                 else train_report["launches"] if kernel in TRAIN_KERNELS
                 else cli_report["launches"] if kernel in CLI_KERNELS
                 else launches)[kernel]
            if kernel == "window_msa":
                many = launches["window_msa_many_heads"]
                n = many if knum == "K2" else n - many
            by = {w: sum(r["bound_ms"] for r in rows if r["bound_by"] == w)
                  for w in ("bytes", "operations")}
            libs = [r["library_ms"] for r in rows]
            kernels.append(dict(
                name=f"{kernel} ({knum})", route="cuda", source=src,
                replaces=replaces, launches=n,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(by.values()),
                bound_by=max(by, key=by.get),
                library_ms=None if None in libs else sum(libs),
                cases=len(rows)))
            if all(r.get("per_step") for r in rows):
                # a train step's launches: each shape's time x its launches
                step = {k: sum(r[k] * r["per_step"] for r in rows)
                        for k in ("ms", "plain_ms", "bound_ms")}
                step["library_ms"] = (None if None in libs else sum(
                    r["library_ms"] * r["per_step"] for r in rows))
                kernels[-1].update({f"{k}_per_step": v
                                    for k, v in step.items()})
                print(f"per train step: {kernel} ({knum}) "
                      f"{sum(r['per_step'] for r in rows)} launches, kernel "
                      f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f}, "
                      f"library {step['library_ms']}, bound "
                      f"{step['bound_ms']:.4f} ms", flush=True)
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise SystemExit(f"kernels the main paths never launched: {idle}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(nvidia_smi=smi_line, device=kind, table=table,
                       img_per_s=throughput, kernels=kernels,
                       eval=eval_report, train=train_report, cli=cli_report,
                       data_parallel=dp_report, sequence_parallel=sp_report,
                       variants=variants_report, data=data_report,
                       classifier=classifier_report,
                       build=dict(seconds=build_s, nvcc_seconds=nvcc_s),
                       whole_model=dict(bf16=err_bf16, fp32=err_fp32)), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
