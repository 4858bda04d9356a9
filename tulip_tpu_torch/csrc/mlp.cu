// Fused two-matmul and LN + matmul kernels.
//
// tulip_two_matmul replaces tulip_tpu/ops/pallas/mlp.py:_kernel:
//   out = [x +] act([LN(x)] W1^T + b1) W2^T [+ b2],  act = exact GELU | leaky
// used for the Swin MLP half-block (C -> 4C -> C, residual) and for the
// folded norm_up + ps_head + decoder_pred head (96 -> 1536 -> 16, leaky).
// tulip_ln_linear replaces mlp.py:_kernel_ln_mm: out = LN(x) W^T (the
// bias-free patch-merging reduction, 4C -> 2C).
// LN statistics, activations and accumulation are fp32; the LN output and
// the hidden activation are rounded to the activation dtype.
//
// bf16: two_matmul_tc_kernel, on the tensor cores (mma.cuh).
// Bound on the H100: 4 N C Hd + 4 N Hd O operations against N (C + O)
// elements moved; at the model's widths the wide stages (C 96, 192) are
// bound by their bytes, the deep ones by the weights each CTA streams from
// L2 and by how many CTAs the few tokens give.  Design: one warpgroup per
// 64 token rows and per slice of the hidden dimension.
//   1. y = [LN](x) as the A operand: for C <= 256 computed here (one warp
//      per row, 16-byte loads, fp32 statistics, rounded once into the
//      swizzled operand layout) and kept in shared memory; wider rows are
//      normalised by ln_rows_kernel into scratch and streamed like a weight.
//   2. Phase A, per 128 hidden units: h = y W1^T summed in registers over
//      64-deep tiles of W1 from the ring; + b1, round, act, round in the
//      register epilogue; a goes to shared memory as the next A operand
//      (64 x slice bf16): the hidden activation never reaches HBM.
//   3. Phase B, per tile of output columns: out = a W2[:, slice]^T summed in
//      registers over the slice, then + b2 + x and one rounding.  No fp32
//      sum lives in shared memory.
// The weight tiles of both phases form one sequence that cp.async keeps one
// tile ahead of the products (a ring of three stages), across tile and
// phase boundaries.
// What bounds it as built: the epilogues (bias, erf GELU, two roundings,
// the swizzled store) and the waits on L2 are hidden only by other warps,
// and a CTA has four.  So the slice is at most what lets two CTAs share an
// SM (ops/mlp.py:two_matmul_plan; 1.2-1.7x faster than one CTA with a
// longer slice), and a launch with few row tiles splits the hidden
// dimension further so that about one CTA per SM runs.  Split launches
// write fp32 partial sums that two_matmul_sum_kernel adds in split order:
// no atomics, so the result does not depend on the schedule.
//
// bf16 LN + matmul (K4): ln_linear_tc_kernel, on the tensor cores.
// Bound on the H100: 2 N K O operations against N (K + O) + O K elements
// moved; with O = K / 2 that is K / 3 operations per byte of bf16, so the
// first merge (K 384) is bound by its bytes and the deeper ones by their
// operations, all within a few microseconds at the model's sizes: what
// matters is that every SM has work and that the weight is read from L2
// once per 64 x BN output tile, not once per 16 rows.  Design:
//   1. ln_linear_ln_kernel (the LN pass of mma.cuh): y = LN(x), rounded
//      once, to scratch.  K >= 384 on every merge: 64 rows of y do not fit
//      beside a ring at K 1,536, and with the output columns split over
//      CTAs an LN inside the product would be repeated per column tile.
//      It costs one write and one read of N K bf16.
//   2. ln_linear_tc_kernel, grid (64-row tiles, tiles of BN output
//      columns, splits of K): one warpgroup, the 64 x BN fp32 sums in
//      registers, BN 192 where it divides O (every merge of the model)
//      else 128; the W tile (BN x 64, K-major as stored) and the y tile
//      (64 x 64) of each 64-deep slab of K arrive together through a ring
//      of three stages (33 or 25 KB each: two CTAs share an SM).  A single
//      split rounds once and stores through a staging tile with 16-byte
//      stores.
//   3. Few row and column tiles (batch 1-4, the deep merges): K is split
//      over CTAs towards one per SM, or two where a split keeps six slabs
//      (ops/mlp.py:ln_linear_plan), every slab in exactly one split; the
//      splits write fp32 partial sums that ln_linear_sum_kernel adds in
//      split order and rounds once: no atomics, equal bits from run to run.
// What bounds it as built: one warpgroup per CTA reads (64 + BN) x 128
// bytes from L2 per 64 x BN x 64 product (48 operations per byte at BN
// 192), so the L2 and the waits on it, not the tensor cores, set the pace
// (125-210 TFLOP/s at batch 8; a chain of 24 slabs alone on its SM is the
// slowest, hence the second CTA); four stages were faster only for one CTA
// per SM and slower for two, so three stayed.  The LN pass (one warp per
// row, three passes over the row) reaches 1.3 TB/s and is half of the
// first merge's time at batch 8.
//
// fp32 K3 (--eval_precision fp32, the default evaluation): split TF32 on
// the tensor cores (mma.cuh), fp32's accuracy; the bound restates as 4 N
// C Hd + 4 N Hd O operations at 494.7 / 3 = 165 TFLOP/s.
//   - two_matmul_tf32_kernel (O <= 96, or 192): two_matmul_tc_kernel's
//     shape, 64 rows a CTA, 64 hidden units a tile.  Phase A streams
//     32-column tiles of W1 and of the CTA's x rows (LN applied as
//     split_rows splits them, from row_stats' fp32 statistics); the 64 x
//     64 sums, + b1, act, split into hi / lo, are the second product's
//     A fragments in registers (a sum
//     fragment is mma.sync's A layout once each 8-column group is taken in
//     the order 0 2 4 6 1 3 5 7, so W2's tile is stored so); phase B adds
//     a W2[bo columns, 64 units]^T into the CTA's bo output columns (bo
//     16 or 32 for the folded head, else 96).  Each tensor-core sum spans
//     one 32-deep tile (phase A) or 64 units (phase B) and is then added
//     to an fp32 total: one chain over all of a split's units had 5-6x
//     the error (2.1e-6 against 3.7e-7 of max|ref| at C 96; PERF.md).
//     The hidden axis splits by the widths alone (ops/mlp.py:
//     two_matmul_plan_f32), so a token's sums run in one order at any
//     token count; two_matmul_sum_f32_kernel adds the splits in order.
//   - Wider outputs would make each output chunk recompute the hidden
//     activation, so they take two launches of linear_tf32_kernel through
//     an (N, Hd) fp32 scratch (its second pass K-split, with the same sum
//     kernel).  Where the fused kernel takes the width it is the faster
//     by device time: 1.9-2.1x at C 96, 2.6-3.2x for the head, even at C
//     192 (batch 1 and 8, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//   - A ring of three 32 KB stages filled by every thread's 16-byte
//     cp.async, each tile split to hi and lo in place (split_tile,
//     stream_split_tiles): 99,840 bytes, two blocks an SM.  Not a TMA /
//     cp.async.bulk ring: every thread reads and rewrites the landed tile
//     for the split before wgmma may read it, so one CTA barrier a tile
//     stays whatever copies the bytes; a ring of raw tiles two ahead of
//     two split buffers, which takes the copies off that path as a bulk
//     ring would, measured within 2 % of this one.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; PERF.md): not its
// tensor-core work nor the split's arithmetic (taking two thirds of the
// products, or the split's conversions, out moved a batch-8 forward's K3
// time by under 10 %); the latency of one warpgroup's chain of tiles, two
// barriers a tile, is what is left.
// fp32 K4 (the patch-merging LN + reduction of the default evaluation):
// split TF32 on the tensor cores too, on linear_tf32_kernel's body (LN
// applied as each 32-deep x tile splits, three TF32 products a product,
// every tile folded into an fp32 total) under its own names, so that a
// profile or a SASS count books it as K4.  Bound: 2 N K O operations at
// 165 TFLOP/s, about 3.7 us a batch-1 merge, above its bytes.
//   - ln_linear_stats_f32_kernel: each row's mean and 1/std once (one warp
//     a row, 16-byte loads, an order fixed by K), 8 bytes a row, for the
//     product's CTAs to read; the product would otherwise re-read its 64
//     rows whole in each of its column tiles x splits of K (48 times at
//     the deepest batch-1 merge; that form measured 1.3-2.3x slower).
//   - ln_linear_tf32_kernel, grid (64-row tiles, 64-column tiles, splits
//     of K): K split by the widths alone, so a token's sums run in one
//     order at any token count, and a W shard or a data rank gives its
//     output bit for bit as one process does.
//   - ln_linear_sum_f32_kernel: the splits' fp32 partial sums added in
//     split order (no bias, no residual).
// What bounds it as built (NVIDIA H100 80GB HBM3, 700 W; PERF.md): each
// batch-1 merge takes about 32 us of device time whatever its width (the
// product about 29 of it, some 2.4 us a 32-deep tile: K3's chain latency
// again), 8-9x its bound; batch 8 reaches about 26 TFLOP/s.
#include "mma.cuh"

namespace tulip {

namespace tc {

constexpr int kHidTile = 128;   // hidden units per phase-A tile
constexpr int kMlpStages = 3;   // ring stages of the weight stream

// [LN](x) of the CTA's 64 rows into the swizzled K-major tiles at ys, for
// C <= 256: one warp per row, one 16-byte chunk per lane, the statistics in
// fp32 (two passes over the registers), the result rounded once.  Each warp
// has the loads of four rows in flight.  Rows beyond N and the tiles'
// columns beyond C are written as finite filler and zeros.
__device__ void rows_to_tiles(const bf16* __restrict__ x,
                              const bf16* __restrict__ lnw,
                              const bf16* __restrict__ lnb, unsigned char* ys,
                              long long r0, int N, int C, float eps) {
  constexpr int kWarps = kWg / 32, kBatch = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = C / 8, tiles = (C + 63) / 64;
  float w[8], b[8];
  if (lnw && lane < chunks) {
    unpack8(*reinterpret_cast<const uint4*>(lnw + lane * 8), w);
    unpack8(*reinterpret_cast<const uint4*>(lnb + lane * 8), b);
  }
  for (int rb = warp; rb < kBM; rb += kWarps * kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long r = r0 + rb + q * kWarps;
      raw[q] = make_uint4(0u, 0u, 0u, 0u);
      if (lane < chunks && r < N)
        raw[q] = *reinterpret_cast<const uint4*>(x + r * C + lane * 8);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int r = rb + q * kWarps;
      float v[8];
      unpack8(raw[q], v);
      if (lnw) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += v[i];
        const float mean = warp_sum(s) / C;
        float sq = 0.f;
        if (lane < chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
        }
        const float rstd = rsqrtf(warp_sum(sq) / C + eps);
        if (lane < chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = (v[i] - mean) * rstd * w[i] + b[i];
        }
      }
      if (lane < tiles * 8)
        *reinterpret_cast<uint4*>(ys + (lane >> 3) * kSub + r * 128 +
                                  (((lane & 7) ^ (r & 7)) << 4)) =
            lane < chunks ? pack8(v) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// grid (row tiles of 64, hidden splits); hs hidden units per split (a
// multiple of 128).  resident: y is made here and kept in shared memory;
// else ysrc (LN(x) from ln_rows_kernel, or x without LN) is streamed beside
// W1.  partial non-null: the split's fp32 sums go to partial[split][N][O].
template <int ACT, int BN2>
__global__ void __launch_bounds__(kWg) two_matmul_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ysrc,
    bf16* __restrict__ out, float* __restrict__ partial,
    const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ b2, int N, int C,
    int Hd, int O, int residual, float eps, int hs, int resident) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BN = kHidTile;
  unsigned char* sm = align_smem(smem_raw);
  const uint32_t stage_bytes = BN * 128 + (resident ? 0u : kSub);
  unsigned char* as_p = sm + kMlpStages * stage_bytes;   // a: hs / 64 tiles
  unsigned char* ys_p = as_p + (hs / 64) * kSub;         // y, if resident
  const uint32_t ring = smem_u32(sm), as = smem_u32(as_p),
                 ys = smem_u32(ys_p);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int h0 = blockIdx.y * hs;
  const int hn = min(hs, Hd - h0);               // this CTA's hidden units
  const int ktc = (C + 63) / 64, kth = (hn + 63) / 64;
  const int nta = (hn + BN - 1) / BN, ntb = (O + BN2 - 1) / BN2;
  const int tiles_a = nta * ktc, T = tiles_a + ntb * kth;
  const int row = frag_row();

  if (resident) rows_to_tiles(x, lnw, lnb, ys_p, r0, N, C, eps);

  float acc[BN / 2], acc2[BN2 / 2];
  auto fetch = [&](int t, uint32_t st) {
    if (t < tiles_a) {      // W1[h0 + 128 i ..][64 j ..] (+ the rows' y)
      const int i = t / ktc, j = t % ktc;
      load_tile(st, w1, C, h0 + i * BN, h0 + hn, j * 64, C, BN);
      if (!resident) load_tile(st + BN * 128, ysrc, C, r0, N, j * 64, C, kBM);
    } else {                // W2[BN2 i ..][h0 + 64 j ..]
      const int u = t - tiles_a, i = u / kth, j = u % kth;
      load_tile(st, w2, Hd, i * BN2, O, h0 + j * 64, h0 + hn, BN2);
    }
  };
  auto use = [&](int t, uint32_t st) {
    if (t < tiles_a) {
      const int i = t / ktc, j = t % ktc;
      mma_tile<BN, 0, 0>(acc, resident ? ys + j * kSub : st + BN * 128, st,
                         min(4, (C - j * 64) / 16), j == 0);
      if (j + 1 < ktc) {
        wgmma_wait<1>();
        return;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      // h = round(sum + b1), a = round(act(h)) -> the slice's A operand
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = i * BN + frag_col(jj);
        float bias0 = 0.f, bias1 = 0.f;
        if (col < hn) {
          bias0 = to_f(b1[h0 + col]);
          bias1 = to_f(b1[h0 + col + 1]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ha = round_to<bf16>(acc[4 * jj + 2 * e] + bias0);
          const float hb = round_to<bf16>(acc[4 * jj + 2 * e + 1] + bias1);
          *reinterpret_cast<uint32_t*>(as_p + (col >> 6) * kSub +
                                       swz(row + 8 * e, col & 63)) =
              pack_bf16(activate<ACT>(ha), activate<ACT>(hb));
        }
      }
    } else {
      const int u = t - tiles_a, i = u / kth, j = u % kth;
      mma_tile<BN2, 0, 0>(acc2, as + j * kSub, st,
                          min(4, (hn - j * 64) / 16), j == 0);
      if (j + 1 < kth) {
        wgmma_wait<1>();
        return;
      }
      wgmma_wait<0>();
      fence_acc(acc2);
#pragma unroll
      for (int jj = 0; jj < BN2 / 8; ++jj) {
        const int oc = i * BN2 + frag_col(jj);
        if (oc >= O) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long r = r0 + row + 8 * e;
          if (r >= N) continue;
          float v0 = acc2[4 * jj + 2 * e], v1 = acc2[4 * jj + 2 * e + 1];
          if (partial) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.y * N + r) * O + oc) =
                make_float2(v0, v1);
            continue;
          }
          if (b2) {
            v0 += to_f(b2[oc]);
            v1 += to_f(b2[oc + 1]);
          }
          if (residual) {
            const __nv_bfloat162 xr =
                *reinterpret_cast<const __nv_bfloat162*>(x + r * C + oc);
            v0 += __low2float(xr);
            v1 += __high2float(xr);
          }
          *reinterpret_cast<uint32_t*>(out + r * O + oc) = pack_bf16(v0, v1);
        }
      }
    }
  };
  stream_tiles<kMlpStages>(ring, stage_bytes, T, fetch, use);
}

// out = round(sum over splits, in split order, + b2 + x): two columns per
// thread.
__global__ void __launch_bounds__(kThreads) two_matmul_sum_kernel(
    const float* __restrict__ partial, const bf16* __restrict__ x,
    const bf16* __restrict__ b2, bf16* __restrict__ out, long long total,
    int O, int C, int splits, int residual) {
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 2;
  if (idx >= total) return;
  const long long r = idx / O;
  const int c = (int)(idx % O);
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 p =
        *reinterpret_cast<const float2*>(partial + (size_t)s * total + idx);
    v0 += p.x;
    v1 += p.y;
  }
  if (b2) {
    v0 += to_f(b2[c]);
    v1 += to_f(b2[c + 1]);
  }
  if (residual) {
    v0 += to_f(x[r * C + c]);
    v1 += to_f(x[r * C + c + 1]);
  }
  *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(v0, v1);
}

// Plan (ops/mlp.py:two_matmul_plan): hs hidden units per split, splits,
// resident, bn2 output columns per phase-B tile, smem bytes.  The kernel
// is refused, not shrunk, when the plan and the kernel's needs differ.
template <int ACT, int BN2>
cudaError_t launch_two_matmul_tc(const bf16* x, bf16* out, const bf16* lnw,
                                 const bf16* lnb, const bf16* w1,
                                 const bf16* b1, const bf16* w2,
                                 const bf16* b2, bf16* y, float* partial,
                                 int N, int C, int Hd, int O, int residual,
                                 float eps, int hs, int splits, int resident,
                                 int smem, cudaStream_t stream) {
  if (C % kKC || Hd % kKC || O % 8 || (residual && O != C) || N <= 0 ||
      hs <= 0 || hs % kHidTile || splits != (Hd + hs - 1) / hs ||
      splits > 65535 || (resident && C > 256) ||
      (splits > 1) != (partial != nullptr) || (!resident && lnw && !y))
    return cudaErrorInvalidValue;
  const uint32_t stage = kHidTile * 128 + (resident ? 0u : kSub);
  const size_t need = 1024 + (size_t)kMlpStages * stage +
                      (size_t)(hs / 64) * kSub +
                      (resident ? (size_t)((C + 63) / 64) * kSub : 0);
  if ((size_t)smem != need) return cudaErrorInvalidValue;
  const bf16* ysrc = x;
  if (!resident && lnw) {
    cudaError_t err =
        launch_ln_rows(x, lnw, lnb, y, nullptr, N, C, eps, stream);
    if (err != cudaSuccess) return err;
    ysrc = y;
  }
  cudaError_t err = prepare_smem(two_matmul_tc_kernel<ACT, BN2>, need);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, splits);
  two_matmul_tc_kernel<ACT, BN2><<<grid, kWg, need, stream>>>(
      x, ysrc, out, partial, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual,
      eps, hs, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * O;
  two_matmul_sum_kernel<<<(unsigned)((total / 2 + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(partial, x, b2, out, total,
                                                 O, C, splits, residual);
  return cudaGetLastError();
}

template <int ACT, typename... Args>
cudaError_t launch_two_matmul_tc_bn2(int bn2, Args... args) {
  if (bn2 == 16) return launch_two_matmul_tc<ACT, 16>(args...);
  if (bn2 == 96) return launch_two_matmul_tc<ACT, 96>(args...);
  if (bn2 == 128) return launch_two_matmul_tc<ACT, 128>(args...);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// LN + matmul (K4)
// ---------------------------------------------------------------------------

constexpr int kLnMmStages = 3;   // ring stages of ln_linear_tc_kernel

__global__ void __launch_bounds__(kThreads) ln_linear_ln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const bf16* __restrict__ lnb, bf16* __restrict__ y,
    float* __restrict__ stat, int N, int C, float eps) {
  ln_rows(x, lnw, lnb, y, stat, N, C, eps);
}

// grid (64-row tiles, tiles of BN output columns, splits of K): the
// split's y W^T over its kts 64-deep slabs of K (the last split may hold
// fewer, never none).  partial null: rounded once to out; else the fp32
// sums go to partial[split][N][O].
template <int BN>
__global__ void __launch_bounds__(kWg) ln_linear_tc_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ w,
    bf16* __restrict__ out, float* __restrict__ partial, int N, int K, int O,
    int kts) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kB = BN * 128;        // W[BN columns][64 k], K-major
  constexpr uint32_t kStage = kB + kSub;   // + y[64 rows][64 k]
  unsigned char* sm = align_smem(smem_raw);
  const uint32_t ring = smem_u32(sm);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kts;
  const int T = min(kts, (K + 63) / 64 - kt0);
  const int row = frag_row();

  float acc[BN / 2];
  auto fetch = [&](int t, uint32_t st) {
    const int k0 = (kt0 + t) * 64;
    load_tile(st, w, K, n0, O, k0, K, BN);
    load_tile(st + kB, y, K, r0, N, k0, K, kBM);
  };
  auto use = [&](int t, uint32_t st) {
    const int k0 = (kt0 + t) * 64;
    mma_tile<BN, 0, 0>(acc, st + kB, st, min(4, (K - k0) / 16), t == 0);
    if (t + 1 < T)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
  };
  stream_tiles<kLnMmStages>(ring, kStage, T, fetch, use);
  fence_acc(acc);

  if (partial) {
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = n0 + frag_col(jj);
      if (col >= O) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long r = r0 + row + 8 * e;
        if (r < N)
          *reinterpret_cast<float2*>(
              partial + ((size_t)blockIdx.z * N + r) * O + col) =
              make_float2(acc[4 * jj + 2 * e], acc[4 * jj + 2 * e + 1]);
      }
    }
    return;
  }
  // the ring is free once every warp's products have read it: it stages
  // the rounded tile for 16-byte stores
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int fc = frag_col(jj);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<uint32_t*>(sm + (fc >> 6) * kSub +
                                   swz(row + 8 * e, fc & 63)) =
          pack_bf16(acc[4 * jj + 2 * e], acc[4 * jj + 2 * e + 1]);
  }
  __syncthreads();
  store_staged(sm, out, O, r0, N, n0, O, BN / 64);
}

// out = round(sum over splits, in split order): two columns per thread.
__global__ void __launch_bounds__(kThreads) ln_linear_sum_kernel(
    const float* __restrict__ partial, bf16* __restrict__ out,
    long long total, int splits) {
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 2;
  if (idx >= total) return;
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 p =
        *reinterpret_cast<const float2*>(partial + (size_t)s * total + idx);
    v0 += p.x;
    v1 += p.y;
  }
  *reinterpret_cast<uint32_t*>(out + idx) = pack_bf16(v0, v1);
}

template <int BN>
cudaError_t launch_ln_linear_product(const bf16* y, const bf16* w, bf16* out,
                                     float* partial, int N, int K, int O,
                                     int kts, int splits, size_t smem,
                                     cudaStream_t stream) {
  cudaError_t err = prepare_smem(ln_linear_tc_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, (O + BN - 1) / BN, splits);
  ln_linear_tc_kernel<BN><<<grid, kWg, smem, stream>>>(y, w, out, partial, N,
                                                       K, O, kts);
  return cudaGetLastError();
}

// Plan (ops/mlp.py:ln_linear_plan): bn output columns per tile, splits of
// K, smem bytes; y (N, K) bf16 and partial (splits, N, O) fp32 (null for
// one split) are scratch.  A plan that differs from the kernel's needs is
// refused.
cudaError_t launch_ln_linear_tc(const bf16* x, bf16* out, const bf16* lnw,
                                const bf16* lnb, const bf16* w, bf16* y,
                                float* partial, int N, int K, int O,
                                float eps, int bn, int splits, int smem,
                                cudaStream_t stream) {
  const int kt = (K + 63) / 64;
  if (K % kKC || O % 8 || N <= 0 || O <= 0 || !y ||
      bn != (O % 192 == 0 ? 192 : 128) || splits < 1 || splits > kt ||
      (O + bn - 1) / bn > 65535 || (splits > 1) != (partial != nullptr))
    return cudaErrorInvalidValue;
  const int kts = (kt + splits - 1) / splits;
  const size_t need = 1024 + (size_t)kLnMmStages * (bn * 128 + kSub);
  if ((kt + kts - 1) / kts != splits || (size_t)smem != need)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_ln_rows(x, lnw, lnb, y, nullptr, N, K, eps, stream,
                                   ln_linear_ln_kernel);
  if (err != cudaSuccess) return err;
  err = bn == 192 ? launch_ln_linear_product<192>(y, w, out, partial, N, K, O,
                                                  kts, splits, need, stream)
                  : launch_ln_linear_product<128>(y, w, out, partial, N, K, O,
                                                  kts, splits, need, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * O;
  ln_linear_sum_kernel<<<(unsigned)((total / 2 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(partial, out, total, splits);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// fp32 K3: two_matmul_tf32_kernel, split TF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTmF32Stages = 3;            // ring stages
constexpr int kTmF32Hid = 64;              // hidden units per tile
constexpr uint32_t kTmF32Half = 128 * 128;   // W1 + x rows, or W2 rows: hi
constexpr uint32_t kTmF32Stage = 2 * kTmF32Half;   // + lo
constexpr uint32_t kTmF32Smem =            // + 64 rows' LN statistics
    1024 + kTmF32Stages * kTmF32Stage + kBM * 8;

// grid (row tiles of 64, tiles of BO output columns, hidden splits); hs
// hidden units per split (a multiple of 64).  Per 64 hidden units of the
// split: h = [LN](x) W1[64 units]^T over 32-column tiles of W1 and of the
// CTA's x rows (split_rows takes the x rows through the LayerNorm, with
// row_stats' statistics, as it splits them); then + b1, act, and split
// into hi / lo A fragments in registers; then out[:, BO columns] += a
// W2[BO columns, 64 units]^T over two 32-deep tiles of W2 stored in the
// fragments' column order.  partial non-null: the split's sums go to
// partial[split][N][O].
template <int ACT, int BO>
__global__ void __launch_bounds__(kWg) two_matmul_tf32_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    float* __restrict__ partial, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, int N, int C, int Hd, int O, int residual,
    float eps, int hs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  float* stat = reinterpret_cast<float*>(sm + kTmF32Stages * kTmF32Stage);
  const uint32_t ring = smem_u32(sm);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int o0 = blockIdx.y * BO;
  const int h0 = blockIdx.z * hs;
  const int hn = min(hs, Hd - h0);                 // this CTA's hidden units
  const int ktc = C / 32, per = ktc + 2;           // tiles per 64 units
  const int T = ((hn + kTmF32Hid - 1) / kTmF32Hid) * per;
  const int row = frag_row();
  float2 st_ln[2];
  if (lnw) {
    row_stats([&](int r) { return r0 + r < N ? x + (r0 + r) * C : nullptr; },
              C, eps, stat);
    __syncthreads();
    thread_stats(stat, st_ln);
  }

  // Every tensor-core sum is short and ends in an fp32 total, as in the
  // two-pass form: phase A's products over C one 32-deep tile at a time,
  // into acc_a / acc_b in turn, each folded into h (mma3_fold); phase B's
  // 64 units at a time into acc2, folded into out2.  The loops below walk
  // the ring (split_tile) so that phase A's registers are dead in phase B
  // and phase B's in phase A.
  float out2[BO / 2] = {};
  auto fetch = [&](int t, uint32_t st) {
    const int i = t / per, j = t % per;
    if (j < ktc) {   // W1 rows h0 + 64 i .., x rows r0 ..; columns 32 j ..
      load_tile_f32(st, w1, C, h0 + i * kTmF32Hid, 32, h0 + hn, j * 32, C,
                    kTmF32Hid);
      load_tile_f32(st + kBM * 128, x, C, r0, 32, N, j * 32, C, kBM);
    } else {         // W2 rows o0 .., columns h0 + 64 i + 32 (j - ktc) ..
      load_tile_f32(st, w2, Hd, o0, 32, O,
                    h0 + i * kTmF32Hid + 32 * (j - ktc), h0 + hn, BO);
    }
  };
  auto split = [&](int t, uint32_t st_addr) {
    unsigned char* st = sm + (st_addr - ring);
    const int j = t % per;
    if (j < ktc) {
      split_rows(st, kTmF32Hid, kTmF32Half, false);
      if (lnw)
        split_rows_ln(st + kBM * 128, kTmF32Half, st_ln, lnw, lnb, j * 32);
      else
        split_rows(st + kBM * 128, kBM, kTmF32Half, false);
    } else {
      split_rows(st, BO, kTmF32Half, true);
    }
  };
  ring_start<kTmF32Stages>(ring, kTmF32Stage, T, fetch);
  for (int i = 0, t = 0; i < T / per; ++i) {
    // phase A: h = [LN](x) W1[64 units]^T; zeroed here, so that no path
    // carries these registers into phase B
    float h[kTmF32Hid / 2], acc_a[kTmF32Hid / 2], acc_b[kTmF32Hid / 2];
#pragma unroll
    for (int k = 0; k < kTmF32Hid / 2; ++k) h[k] = acc_a[k] = acc_b[k] = 0.f;
    for (int j = 0; j < ktc; ++j, ++t) {
      const uint32_t buf =
          split_tile<kTmF32Stages>(ring, kTmF32Stage, T, t, fetch, split);
      const uint32_t a_hi = buf + kBM * 128, a_lo = a_hi + kTmF32Half;
      if (j & 1)
        mma3_fold<kTmF32Hid>(h, acc_b, acc_a, a_hi, a_lo, buf,
                             buf + kTmF32Half, false, j + 1 == ktc);
      else
        mma3_fold<kTmF32Hid>(h, acc_a, acc_b, a_hi, a_lo, buf,
                             buf + kTmF32Half, j == 0, j + 1 == ktc);
    }
    // a = act(h + b1) as A fragments: k-step jj is units 8 jj .. 8 jj + 7
    // of the tile, a0 / a1 / a2 / a3 the sums e = 0 / 2 / 1 / 3
    uint32_t ahi[8][4], alo[8][4];
#pragma unroll
    for (int jj = 0; jj < kTmF32Hid / 8; ++jj) {
      const int hc = i * kTmF32Hid + frag_col(jj);
      const bool ok = hc < hn;   // hn % 32 == 0: both columns or neither
      float2 bb = make_float2(0.f, 0.f);
      if (ok) bb = *reinterpret_cast<const float2*>(b1 + h0 + hc);
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = ok ? activate<ACT>(h[4 * jj + e] + (e & 1 ? bb.y : bb.x))
                  : 0.f;
      split_tf32(a[0], ahi[jj][0], alo[jj][0]);
      split_tf32(a[2], ahi[jj][1], alo[jj][1]);
      split_tf32(a[1], ahi[jj][2], alo[jj][2]);
      split_tf32(a[3], ahi[jj][3], alo[jj][3]);
    }
    // phase B: out2 += a W2[BO columns, these 64 units]^T, two 32-deep
    // tiles of W2
    float acc2[BO / 2];
    uint32_t buf =
        split_tile<kTmF32Stages>(ring, kTmF32Stage, T, t++, fetch, split);
    mma3_tile_rs<BO, 0>(acc2, ahi, alo, buf, buf + kTmF32Half, true);
    wgmma_wait<1>();
    buf = split_tile<kTmF32Stages>(ring, kTmF32Stage, T, t++, fetch, split);
    mma3_tile_rs<BO, 1>(acc2, ahi, alo, buf, buf + kTmF32Half, false);
    // the fragments are rewritten by the next 64 units: every product
    // that reads them ends here
    wgmma_wait<0>();
    fence_regs(ahi);
    fence_regs(alo);
    fold(out2, acc2);
  }
#pragma unroll
  for (int jj = 0; jj < BO / 8; ++jj) {
    const int oc = o0 + frag_col(jj);
    if (oc >= O) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long r = r0 + row + 8 * e;
      if (r >= N) continue;
      float v0 = out2[4 * jj + 2 * e], v1 = out2[4 * jj + 2 * e + 1];
      if (partial) {
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * N + r) * O + oc) =
            make_float2(v0, v1);
        continue;
      }
      if (b2) {
        const float2 bb = *reinterpret_cast<const float2*>(b2 + oc);
        v0 += bb.x;
        v1 += bb.y;
      }
      if (residual) {
        const float2 xr = *reinterpret_cast<const float2*>(x + r * C + oc);
        v0 += xr.x;
        v1 += xr.y;
      }
      *reinterpret_cast<float2*>(out + r * O + oc) = make_float2(v0, v1);
    }
  }
}

// out = sum over splits, in split order, + b2 + x, fp32: two columns per
// thread.
__global__ void __launch_bounds__(kThreads) two_matmul_sum_f32_kernel(
    const float* __restrict__ partial, const float* __restrict__ x,
    const float* __restrict__ b2, float* __restrict__ out, long long total,
    int O, int C, int splits, int residual) {
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 2;
  if (idx >= total) return;
  const long long r = idx / O;
  const int c = (int)(idx % O);
  float v0 = 0.f, v1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 p =
        *reinterpret_cast<const float2*>(partial + (size_t)s * total + idx);
    v0 += p.x;
    v1 += p.y;
  }
  if (b2) {
    v0 += b2[c];
    v1 += b2[c + 1];
  }
  if (residual) {
    v0 += x[r * C + c];
    v1 += x[r * C + c + 1];
  }
  *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
}

// The two-pass form, for outputs wider than two chunks of one CTA's
// register sums (O > 192): each output chunk of the fused kernel would
// recompute the hidden activation, so instead h = act([LN](x) W1^T + b1)
// goes to an (N, Hd) scratch and out = h W2^T + b2 [+ x] reads it back,
// each pass one launch of linear_tf32_kernel, K of the second split over
// CTAs where the tiles are few.
// grid (row tiles of 64, tiles of 64 output columns, splits of K); kts
// 32-deep tiles of K a split (the last may hold fewer).  sum = [LN](a)
// b^T over the split's tiles (a: N x K rows, LN applied in split_rows_ln
// with the statistics stats(r0, stat) leaves in shared memory; b: ncols x
// K, torch layout); HIDDEN: act(sum + bias) to out (N x ncols); else
// partial non-null: the split's sums to partial[split][N][ncols]; else sum
// [+ bias] [+ x] to out.  The body of K3's linear_tf32_kernel and of K4's
// ln_linear_tf32_kernel.
template <int ACT, bool HIDDEN, typename Stats>
__device__ __forceinline__ void linear_tf32_tile(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ bias, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ x,
    float* __restrict__ out, float* __restrict__ partial, int N, int K,
    int ncols, int kts, Stats stats) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  float* stat = reinterpret_cast<float*>(sm + kTmF32Stages * kTmF32Stage);
  const uint32_t ring = smem_u32(sm);
  const long long r0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * 64, kt0 = blockIdx.z * kts;
  const int T = min(kts, K / 32 - kt0);
  const int row = frag_row();
  float2 st_ln[2];
  if (lnw) {
    stats(r0, stat);
    __syncthreads();
    thread_stats(stat, st_ln);
  }
  // each tile's products to a fresh accumulator, one of two that
  // alternate, folded into sum once they end
  float acc_a[32], acc_b[32], sum[32];
  auto fetch = [&](int t, uint32_t st) {
    const int k0 = (kt0 + t) * 32;
    load_tile_f32(st, b, K, n0, 32, ncols, k0, K, 64);
    load_tile_f32(st + kBM * 128, a, K, r0, 32, N, k0, K, kBM);
  };
  auto split = [&](int t, uint32_t st_addr) {
    unsigned char* st = sm + (st_addr - ring);
    split_rows(st, 64, kTmF32Half, false);
    if (lnw)
      split_rows_ln(st + kBM * 128, kTmF32Half, st_ln, lnw, lnb,
                    (kt0 + t) * 32);
    else
      split_rows(st + kBM * 128, kBM, kTmF32Half, false);
  };
  auto use = [&](int t, uint32_t st) {
    const uint32_t a_hi = st + kBM * 128, a_lo = a_hi + kTmF32Half;
    if (t & 1)
      mma3_fold<64>(sum, acc_b, acc_a, a_hi, a_lo, st, st + kTmF32Half,
                    t == 0, t + 1 == T);
    else
      mma3_fold<64>(sum, acc_a, acc_b, a_hi, a_lo, st, st + kTmF32Half,
                    t == 0, t + 1 == T);
  };
  stream_split_tiles<kTmF32Stages>(ring, kTmF32Stage, T, fetch, split,
                                   use);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = n0 + frag_col(jj);
    if (col >= ncols) continue;
    float2 bb = make_float2(0.f, 0.f);
    if (bias && (HIDDEN || !partial))
      bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long r = r0 + row + 8 * e;
      if (r >= N) continue;
      float v0 = sum[4 * jj + 2 * e], v1 = sum[4 * jj + 2 * e + 1];
      if (HIDDEN) {
        v0 = activate<ACT>(v0 + bb.x);
        v1 = activate<ACT>(v1 + bb.y);
      } else if (partial) {
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * N + r) * ncols + col) =
            make_float2(v0, v1);
        continue;
      } else {
        v0 += bb.x;
        v1 += bb.y;
        if (x) {
          const float2 xr =
              *reinterpret_cast<const float2*>(x + r * ncols + col);
          v0 += xr.x;
          v1 += xr.y;
        }
      }
      *reinterpret_cast<float2*>(out + r * ncols + col) = make_float2(v0, v1);
    }
  }
}

// K3's two passes: linear_tf32_tile with the statistics of row_stats.
template <int ACT, bool HIDDEN>
__global__ void __launch_bounds__(kWg) linear_tf32_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ bias, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ x,
    float* __restrict__ out, float* __restrict__ partial, int N, int K,
    int ncols, int kts, float eps) {
  linear_tf32_tile<ACT, HIDDEN>(
      a, b, bias, lnw, lnb, x, out, partial, N, K, ncols, kts,
      [&](long long r0, float* stat) {
        row_stats(
            [&](int r) { return r0 + r < N ? a + (r0 + r) * K : nullptr; },
            K, eps, stat);
      });
}

// The two passes under the plan's two-pass form: h (N x Hd fp32 scratch),
// hs hidden units per split of the second pass (a multiple of 32), splits.
template <int ACT>
cudaError_t launch_two_matmul_tf32_2p(const float* x, float* out,
                                      const float* lnw, const float* lnb,
                                      const float* w1, const float* b1,
                                      const float* w2, const float* b2,
                                      float* h, float* partial, int N, int C,
                                      int Hd, int O, int residual, float eps,
                                      int hs, int splits, int smem,
                                      cudaStream_t stream) {
  if (C % kKC || Hd % kKC || O % 8 || (residual && O != C) || N <= 0 ||
      hs <= 0 || hs % kKC || splits != (Hd + hs - 1) / hs ||
      splits > 65535 || (splits > 1) != (partial != nullptr) ||
      (size_t)smem != kTmF32Smem)
    return cudaErrorInvalidValue;
  const unsigned rt = (N + kBM - 1) / kBM;
  cudaError_t err = prepare_smem(linear_tf32_kernel<ACT, true>, kTmF32Smem);
  if (err != cudaSuccess) return err;
  linear_tf32_kernel<ACT, true><<<dim3(rt, (Hd + 63) / 64, 1), kWg,
                                  kTmF32Smem, stream>>>(
      x, w1, b1, lnw, lnb, nullptr, h, nullptr, N, C, Hd, C / 32, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = prepare_smem(linear_tf32_kernel<kGelu, false>, kTmF32Smem)) !=
      cudaSuccess)
    return err;
  linear_tf32_kernel<kGelu, false><<<dim3(rt, (O + 63) / 64, splits), kWg,
                                     kTmF32Smem, stream>>>(
      h, w2, b2, nullptr, nullptr, residual ? x : nullptr, out, partial, N,
      Hd, O, hs / 32, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * O;
  two_matmul_sum_f32_kernel<<<(unsigned)((total / 2 + kThreads - 1) /
                                         kThreads),
                              kThreads, 0, stream>>>(partial, x, b2, out,
                                                     total, O, C, splits,
                                                     residual);
  return cudaGetLastError();
}

// Plan (ops/mlp.py:two_matmul_plan_f32): hs hidden units per split,
// splits, bo output columns per CTA, smem bytes.  Refused, not reshaped,
// where the plan and the kernel's needs differ.
template <int ACT, int BO>
cudaError_t launch_two_matmul_tf32(const float* x, float* out,
                                   const float* lnw, const float* lnb,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   float* partial, int N, int C, int Hd,
                                   int O, int residual, float eps, int hs,
                                   int splits, int smem,
                                   cudaStream_t stream) {
  if (C % kKC || Hd % kKC || O % 8 || (residual && O != C) || N <= 0 ||
      hs <= 0 || hs % kTmF32Hid || splits != (Hd + hs - 1) / hs ||
      splits > 65535 || (O + BO - 1) / BO > 65535 ||
      (splits > 1) != (partial != nullptr) || (size_t)smem != kTmF32Smem)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare_smem(two_matmul_tf32_kernel<ACT, BO>, kTmF32Smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, (O + BO - 1) / BO, splits);
  two_matmul_tf32_kernel<ACT, BO><<<grid, kWg, kTmF32Smem, stream>>>(
      x, out, partial, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps,
      hs);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * O;
  two_matmul_sum_f32_kernel<<<(unsigned)((total / 2 + kThreads - 1) /
                                         kThreads),
                              kThreads, 0, stream>>>(partial, x, b2, out,
                                                     total, O, C, splits,
                                                     residual);
  return cudaGetLastError();
}

template <int ACT, typename... Args>
cudaError_t launch_two_matmul_tf32_bo(int bo, Args... args) {
  if (bo == 16) return launch_two_matmul_tf32<ACT, 16>(args...);
  if (bo == 32) return launch_two_matmul_tf32<ACT, 32>(args...);
  if (bo == 96) return launch_two_matmul_tf32<ACT, 96>(args...);
  return cudaErrorInvalidValue;
}

// The fused kernel at bo output columns a CTA, or with the (N, Hd) scratch
// h the two-pass form.
template <int ACT>
cudaError_t launch_two_matmul_tf32_plan(int bo, const float* x, float* out,
                                        const float* lnw, const float* lnb,
                                        const float* w1, const float* b1,
                                        const float* w2, const float* b2,
                                        float* h, float* partial, int N,
                                        int C, int Hd, int O, int residual,
                                        float eps, int hs, int splits,
                                        int smem, cudaStream_t stream) {
  if (h)
    return bo == 64 ? launch_two_matmul_tf32_2p<ACT>(
                          x, out, lnw, lnb, w1, b1, w2, b2, h, partial, N, C,
                          Hd, O, residual, eps, hs, splits, smem, stream)
                    : cudaErrorInvalidValue;
  return launch_two_matmul_tf32_bo<ACT>(bo, x, out, lnw, lnb, w1, b1, w2, b2,
                                        partial, N, C, Hd, O, residual, eps,
                                        hs, splits, smem, stream);
}


// ---------------------------------------------------------------------------
// fp32 K4: ln_linear_tf32_kernel, split TF32 on the tensor cores
// ---------------------------------------------------------------------------

// The statistics pass: stat[r] = (mean, 1/std) of row r, one warp a row.
__global__ void __launch_bounds__(kThreads) ln_linear_stats_f32_kernel(
    const float* __restrict__ x, float2* __restrict__ stat, int N, int K,
    float eps) {
  const long long r =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= N) return;
  const float2 v = row_mean_rstd(x + r * K, K, eps);
  if ((threadIdx.x & 31) == 0) stat[r] = v;
}

// grid (row tiles of 64, tiles of 64 output columns, splits of K): the
// split's LN(x) w^T over its kts 32-deep tiles of K (linear_tf32_tile; w
// O x K in torch layout), the rows' statistics gstat from the statistics
// pass.  partial null: the sums to out; else to partial[split][N][O].
__global__ void __launch_bounds__(kWg) ln_linear_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float2* __restrict__ gstat, float* __restrict__ out,
    float* __restrict__ partial, int N, int K, int O, int kts) {
  linear_tf32_tile<kGelu, false>(
      x, w, nullptr, lnw, lnb, nullptr, out, partial, N, K, O, kts,
      [&](long long r0, float* stat) {
        for (int r = threadIdx.x; r < kBM; r += kWg) {
          const float2 v = r0 + r < N ? gstat[r0 + r] : make_float2(0.f, 0.f);
          stat[2 * r] = v.x;
          stat[2 * r + 1] = v.y;
        }
      });
}

// out = sum over splits, in split order, fp32: two columns per thread.
__global__ void __launch_bounds__(kThreads) ln_linear_sum_f32_kernel(
    const float* __restrict__ partial, float* __restrict__ out,
    long long total, int splits) {
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 2;
  if (idx >= total) return;
  float2 v = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 p =
        *reinterpret_cast<const float2*>(partial + (size_t)s * total + idx);
    v.x += p.x;
    v.y += p.y;
  }
  *reinterpret_cast<float2*>(out + idx) = v;
}

// Plan (ops/mlp.py:ln_linear_plan_f32): bn (64) output columns a CTA,
// splits of K, every 32-deep tile in exactly one split (kts tiles each,
// the last may hold fewer), smem; stat (N float2) the statistics pass's
// scratch; partial (splits, N, O) for more than one split.  A plan that
// differs from the kernel's needs is refused.
cudaError_t launch_ln_linear_tf32(const float* x, float* out,
                                  const float* lnw, const float* lnb,
                                  const float* w, float2* stat,
                                  float* partial, int N, int K, int O,
                                  float eps, int bn, int splits, int smem,
                                  cudaStream_t stream) {
  const int kt = K / 32;
  if (K % kKC || O % 2 || N <= 0 || O <= 0 || !stat || bn != 64 ||
      splits < 1 || splits > kt || (O + 63) / 64 > 65535 ||
      (splits > 1) != (partial != nullptr) || (size_t)smem != kTmF32Smem)
    return cudaErrorInvalidValue;
  const int kts = (kt + splits - 1) / splits;
  if ((kt + kts - 1) / kts != splits) return cudaErrorInvalidValue;
  const int per = kThreads / 32;
  ln_linear_stats_f32_kernel<<<(unsigned)((N + per - 1) / per), kThreads, 0,
                               stream>>>(x, stat, N, K, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = prepare_smem(ln_linear_tf32_kernel, kTmF32Smem)) != cudaSuccess)
    return err;
  ln_linear_tf32_kernel<<<dim3((N + kBM - 1) / kBM, (O + 63) / 64, splits),
                          kWg, kTmF32Smem, stream>>>(
      x, w, lnw, lnb, stat, out, partial, N, K, O, kts);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)N * O;
  ln_linear_sum_f32_kernel<<<(unsigned)((total / 2 + kThreads - 1) /
                                        kThreads),
                             kThreads, 0, stream>>>(partial, out, total,
                                                    splits);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// fp32: the split-TF32 kernels under the plan (hs, splits, bn2 = output
// columns per CTA, smem); y null: the fused kernel, else y is the (N, Hd)
// hidden scratch of the two-pass form; resident is not read.  bf16: the
// tensor-core kernel under that plan.
extern "C" int tulip_two_matmul(int dtype, int act, const void* x, void* out,
                                const void* lnw, const void* lnb,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, void* y,
                                void* partial, int N, int C, int Hd, int O,
                                int residual, float eps, int hs, int splits,
                                int resident, int bn2, int smem,
                                void* stream) {
  using tulip::kGelu;
  using tulip::kLeaky;
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
#define TULIP_TM_F32(ACT)                                                    \
  return tulip::tc::launch_two_matmul_tf32_plan<ACT>(                        \
      bn2, static_cast<const float*>(x), static_cast<float*>(out),           \
      static_cast<const float*>(lnw), static_cast<const float*>(lnb),        \
      static_cast<const float*>(w1), static_cast<const float*>(b1),          \
      static_cast<const float*>(w2), static_cast<const float*>(b2),          \
      static_cast<float*>(y), static_cast<float*>(partial), N, C, Hd, O,     \
      residual, eps, hs, splits, smem, s)
  if (dtype == 0 && act == kGelu) TULIP_TM_F32(kGelu);
  if (dtype == 0 && act == kLeaky) TULIP_TM_F32(kLeaky);
#undef TULIP_TM_F32
  if (dtype != 1) return cudaErrorInvalidValue;
#define TULIP_TM_TC(ACT)                                                     \
  return tulip::tc::launch_two_matmul_tc_bn2<ACT>(                           \
      bn2, static_cast<const bf16*>(x), static_cast<bf16*>(out),             \
      static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),          \
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),            \
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),            \
      static_cast<bf16*>(y), static_cast<float*>(partial), N, C, Hd, O,      \
      residual, eps, hs, splits, resident, smem, s)
  if (act == kGelu) TULIP_TM_TC(kGelu);
  if (act == kLeaky) TULIP_TM_TC(kLeaky);
#undef TULIP_TM_TC
  return cudaErrorInvalidValue;
}

// fp32: the statistics pass to y, the (N, 2) fp32 scratch, and the
// split-TF32 kernels under the plan (bn, splits, smem); partial (splits,
// N, O) fp32 for more than one split.  bf16: the LN pass to y, the
// tensor-core product under that plan and, for more than one split, the
// sum pass.
extern "C" int tulip_ln_linear(int dtype, const void* x, void* out,
                               const void* lnw, const void* lnb,
                               const void* w, void* y, void* partial, int N,
                               int K, int O, float eps, int bn, int splits,
                               int smem, void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::tc::launch_ln_linear_tf32(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<const float*>(lnw), static_cast<const float*>(lnb),
        static_cast<const float*>(w), static_cast<float2*>(y),
        static_cast<float*>(partial), N, K, O, eps, bn, splits, smem, s);
  if (dtype == 1)
    return tulip::tc::launch_ln_linear_tc(
        static_cast<const bf16*>(x), static_cast<bf16*>(out),
        static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),
        static_cast<const bf16*>(w), static_cast<bf16*>(y),
        static_cast<float*>(partial), N, K, O, eps, bn, splits, smem, s);
  return cudaErrorInvalidValue;
}
