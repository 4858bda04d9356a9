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
// fp32: two_matmul_kernel and ln_linear_kernel, the FMA kernels on the CUDA
// cores (16 rows per CTA, common.cuh), the parity path.
#include "mma.cuh"

namespace tulip {

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads) two_matmul_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ lnw,
    const T* __restrict__ lnb, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, int N, int C, int Hd, int O, int residual,
    float eps) {
  extern __shared__ float smem[];
  float* xn = smem;                       // [16][C]  [LN](x)
  float* acc = xn + kRows * C;            // [16][O]  second product
  float* hs = acc + kRows * O;            // [16][64] hidden chunk
  float* wtile = hs + kRows * kHidChunk;

  const long long r0 = (long long)blockIdx.x * kRows;
  load_rows(x, xn, r0, N, C);
  for (int i = threadIdx.x; i < kRows * O; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  if (lnw) layer_norm_rows<T>(xn, C, C, lnw, lnb, eps);

  for (int h0 = 0; h0 < Hd; h0 += kHidChunk) {
    const int nh = min(kHidChunk, Hd - h0);
    gemm_rows<T>(xn, C, C, w1 + (size_t)h0 * C, C, identity_rows(), nh, wtile,
                 [&](int r, int n, float v) {
                   const float h = round_to<T>(v + to_f(b1[h0 + n]));
                   hs[r * kHidChunk + n] = round_to<T>(activate<ACT>(h));
                 });
    gemm_rows<T>(hs, kHidChunk, nh, w2 + h0, Hd, identity_rows(), O, wtile,
                 [&](int r, int n, float v) { acc[r * O + n] += v; });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * O; i += kThreads) {
    const long long r = r0 + i / O;
    const int n = i % O;
    if (r >= N) continue;
    float v = acc[i];
    if (b2) v += to_f(b2[n]);
    if (residual) v += to_f(x[r * C + n]);
    out[r * O + n] = from_f<T>(v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_linear_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ lnw,
    const T* __restrict__ lnb, const T* __restrict__ w, int N, int K, int O,
    float eps) {
  extern __shared__ float smem[];
  float* xn = smem;                       // [16][K]
  float* wtile = xn + kRows * K;
  const long long r0 = (long long)blockIdx.x * kRows;
  load_rows(x, xn, r0, N, K);
  __syncthreads();
  layer_norm_rows<T>(xn, K, K, lnw, lnb, eps);
  gemm_rows<T>(xn, K, K, w, K, identity_rows(), O, wtile,
               [&](int r, int n, float v) {
                 if (r0 + r < N) out[(r0 + r) * O + n] = from_f<T>(v);
               });
}

template <typename T, int ACT>
cudaError_t launch_two_matmul(const void* x, void* out, const void* lnw,
                              const void* lnb, const void* w1, const void* b1,
                              const void* w2, const void* b2, int N, int C,
                              int Hd, int O, int residual, float eps,
                              cudaStream_t stream) {
  if (C % kKC || Hd % kKC || (residual && O != C) || N <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kRows * C + kRows * O +
                                       kRows * kHidChunk + kWTileFloats);
  cudaError_t err = prepare_smem(two_matmul_kernel<T, ACT>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  two_matmul_kernel<T, ACT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), N, C, Hd, O,
      residual, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_linear(const void* x, void* out, const void* lnw,
                             const void* lnb, const void* w, int N, int K,
                             int O, float eps, cudaStream_t stream) {
  if (K % kKC || N <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kRows * K + kWTileFloats);
  cudaError_t err = prepare_smem(ln_linear_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  ln_linear_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w), N, K, O, eps);
  return cudaGetLastError();
}

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

}  // namespace tc

}  // namespace tulip

// fp32: the FMA kernel; y, partial and the plan (hs, splits, resident, bn2,
// smem) are not read.  bf16: the tensor-core kernel under that plan.
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
  if (dtype == 0 && act == kGelu)
    return tulip::launch_two_matmul<float, kGelu>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
  if (dtype == 0 && act == kLeaky)
    return tulip::launch_two_matmul<float, kLeaky>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
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

// fp32: the FMA kernel; y, partial and the plan (bn, splits, smem) are not
// read.  bf16: the LN pass, the tensor-core product under that plan and,
// for more than one split, the sum pass.
extern "C" int tulip_ln_linear(int dtype, const void* x, void* out,
                               const void* lnw, const void* lnb,
                               const void* w, void* y, void* partial, int N,
                               int K, int O, float eps, int bn, int splits,
                               int smem, void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::launch_ln_linear<float>(x, out, lnw, lnb, w, N, K, O, eps,
                                          s);
  if (dtype == 1)
    return tulip::tc::launch_ln_linear_tc(
        static_cast<const bf16*>(x), static_cast<bf16*>(out),
        static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),
        static_cast<const bf16*>(w), static_cast<bf16*>(y),
        static_cast<float*>(partial), N, K, O, eps, bn, splits, smem, s);
  return cudaErrorInvalidValue;
}
