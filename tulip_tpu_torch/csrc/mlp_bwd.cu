// Backward of the fused two-matmul (K10) and of LN + matmul (K11): the
// token-parallel pass.
//
// tulip_two_matmul_bwd replaces tulip_tpu/ops/pallas/mlp.py:_bwd_kernel.
// With y = [LN](x), h = y W1^T + b1, a = act(h), out = a W2^T [+ b2] [+ x]
// and g = dL/dout, it recomputes y and h and computes
//   da = g W2,  dh = da * act'(h),  dy = dh W1,  dx = LN^T(dy) [+ g],
// writing dx, and to HBM scratch y (N, C), a (N, Hd) and dh (N, Hd) plus
// the dlnw | dlnb partial sums of every 16 rows.  tulip_ln_linear_bwd
// replaces mlp.py:_kernel_ln_mm_bwd (out = LN(x) W^T): dy = g W,
// dx = LN^T(dy), y to scratch and the dlnw | dlnb partials.
//
// The weight gradients, dW1 = dh^T y, dW2 = g^T a, dW = g^T y, and the
// bias / LN sums (db1 = colsum dh, db2 = colsum g, dlnw / dlnb = colsum of
// the partials) are the second pass, reduce.cu.  The TPU kernel kept them
// in one VMEM block across its in-order grid; on the H100 they would be
// (Hd x C) fp32 per CTA (9.4 MB at stage 3), so the token pass stores its
// operands instead: 2 N Hd elements of scratch (805 MB in bf16 for the
// head at batch 8, N 131,072 x Hd 1,536), written once and read once.
// Every reduction runs in a fixed order: results are deterministic.
//
// Activation: the exact erf GELU (or leaky ReLU) that tulip_two_matmul's
// forward computes, differentiated at the same rounded h.  Rounding
// points, bf16: y, h, a and dh are rounded to the activation dtype (dh
// before dy and before dW1 / db1, as in the TPU kernel); da, dy, the LN
// backward and every accumulation are fp32; dx is rounded once.
//
// bf16, on the tensor cores (mma.cuh).  Bound on the H100: 2 N Hd (2 C +
// O) operations for h, da and dy against the a and dh scratch (4 N Hd
// bytes written, 2 N Hd read back) that the second pass needs anyway: the
// wide stages are bound by those bytes, the deep ones by the weights each
// CTA streams from L2.  The sums that one CTA would have to hold (dy: 64 x
// C fp32 beside y, g and a slice of dh) do not fit shared memory at C 768,
// and a split of the hidden dimension would cost one fp32 dy per slice.  So
// the pass is four launches, each a plain tiled product whose operands
// stream through the ring:
//   1. ln_rows_kernel: y = LN(x) and the rows' mean, 1/std to scratch.
//   2. mlp_bwd_hidden_kernel, grid (64-row tiles, 128 hidden units): h = y
//      W1^T (K-major weight tiles), + b1, round, a = act(h) to scratch,
//      act'(h) kept in registers (one erf for both); da = g W2[:, tile]
//      (MN-major tiles of W2, no transposed copy), dh = round(da act'(h)) to
//      scratch.  a and dh leave through a staging tile with 16-byte stores.
//   3. mlp_bwd_dy_kernel, grid (row tiles, tiles of C, splits of Hd): dy =
//      dh W1 (MN-major tiles of W1) summed in registers, fp32 to scratch;
//      Hd is split only when the grid would leave SMs idle.
//   4. mlp_bwd_finish_kernel, 16 rows per CTA: the splits' dy added in
//      split order, then the LN backward (ln_backward_rows) and + g.
//
// bf16 LN + matmul backward (K11), on the tensor cores.  Bound on the
// H100: 2 N K O operations for dy (dW = g^T y is tn_gemm's, reduce.cu)
// against x, g in and dx out, N (2 K + O) elements: bytes at the first
// merge, operations below it.  It is K10's token pass without the hidden
// layer, so it runs three of K10's four launches under kernel names of its
// own (one body each, so the two share every bit of arithmetic):
//   1. ln_linear_bwd_ln_kernel: y = LN(x) and the rows' mean, 1/std.
//   2. ln_linear_bwd_dy_kernel, grid (row tiles, tiles of K, splits of O):
//      dy = g W (MN-major tiles of W, no transposed copy) in fp32 to
//      scratch; O is split only when the grid would leave SMs idle
//      (ops/mlp.py:dy_splits).
//   3. ln_linear_bwd_finish_kernel, 16 rows per CTA: the splits' dy added
//      in split order, the LN backward and the dlnw | dlnb partials.
// What bounds it as built: the fp32 dy round trip (8 N K bytes, more than
// x, g and dx together) and, at the deep merges, the L2 reads of one
// warpgroup per CTA, as in K10.
//
// fp32: two_matmul_bwd_kernel and ln_linear_bwd_kernel, one launch each on
// the CUDA cores (16 rows per CTA, common.cuh), the parity path.
#include "mma.cuh"

namespace tulip {

__host__ __device__ constexpr int round_up_kc(int v) {
  return (v + kKC - 1) / kKC * kKC;
}

// LayerNorm backward of the tile (one warp per row): from dy (fp32 shared,
// row stride C) and the forward statistics, dx = rstd (dxh - mean(dxh) -
// xh mean(dxh xh)) with dxh = dy lnw, plus res (shared, row stride ldres,
// or null); then the tile's column sums dlnw = sum dy xh and dlnb =
// sum dy into part[0, C) and part[C, 2C).  Without lnw, dx = dy [+ res].
template <typename T>
__device__ void ln_backward_rows(const T* x, const float* dy,
                                 const float* stat, const T* lnw,
                                 const float* res, int ldres, T* dx,
                                 float* part, long long r0, int N, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    if (r0 + r >= N) continue;
    const float* d = dy + r * C;
    const T* xr = x + (r0 + r) * C;
    T* out = dx + (r0 + r) * C;
    if (!lnw) {
      for (int c = lane; c < C; c += 32)
        out[c] = from_f<T>(d[c] + (res ? res[r * ldres + c] : 0.f));
      continue;
    }
    const float mean = stat[2 * r], rstd = stat[2 * r + 1];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = d[c] * to_f(lnw[c]);
      s1 += dxh;
      s2 += dxh * (to_f(xr[c]) - mean) * rstd;
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      float v = rstd * (d[c] * to_f(lnw[c]) - s1 - xh * s2);
      if (res) v += res[r * ldres + c];
      out[c] = from_f<T>(v);
    }
  }
  if (!lnw) return;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float sw = 0.f, sb = 0.f;
    for (int r = 0; r < kRows && r0 + r < N; ++r) {
      const float xh = (to_f(x[(r0 + r) * C + c]) - stat[2 * r]) *
                       stat[2 * r + 1];
      sw += dy[r * C + c] * xh;
      sb += dy[r * C + c];
    }
    part[c] = sw;
    part[C + c] = sb;
  }
}

// Write the tile's rounded LN output (fp32 shared, row stride C) to y.
template <typename T>
__device__ void store_rows(const float* s, T* y, long long r0, int N, int C) {
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const long long r = r0 + i / C;
    if (r < N) y[r * C + i % C] = from_f<T>(s[i]);
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads) two_matmul_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const T* __restrict__ lnw, const T* __restrict__ lnb,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, T* __restrict__ dx, T* __restrict__ y_out,
    T* __restrict__ a_out, T* __restrict__ dh_out, float* __restrict__ part,
    int N, int C, int Hd, int O, int residual, float eps) {
  extern __shared__ float smem[];
  const int Op = round_up_kc(O);
  float* ys = smem;                        // [16][C]  [LN](x), rounded
  float* dys = ys + kRows * C;             // [16][C]  dL/dy
  float* gs = dys + kRows * C;             // [16][Op] g, zero-padded
  float* dact = gs + kRows * Op;           // [16][64] act'(h) of the chunk
  float* dhs = dact + kRows * kHidChunk;   // [16][64] dh of the chunk
  float* stat = dhs + kRows * kHidChunk;   // [16][2]  LN mean, rstd
  float* wtile = stat + 2 * kRows;

  const long long r0 = (long long)blockIdx.x * kRows;
  load_rows(x, ys, r0, N, C);
  load_rows(g, gs, r0, N, O, Op);
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) dys[i] = 0.f;
  __syncthreads();
  if (lnw) {
    layer_norm_rows<T>(ys, C, C, lnw, lnb, eps, stat);
    __syncthreads();
    store_rows(ys, y_out, r0, N, C);
  }

  for (int h0 = 0; h0 < Hd; h0 += kHidChunk) {
    const int nh = min(kHidChunk, Hd - h0);
    // h = y W1^T + b1 (rounded), a = act(h): a to scratch, act'(h) kept
    gemm_rows<T>(ys, C, C, w1 + (size_t)h0 * C, C, identity_rows(), nh,
                 wtile, [&](int r, int n, float v) {
                   const float h = round_to<T>(v + to_f(b1[h0 + n]));
                   if (r0 + r < N)
                     a_out[(r0 + r) * Hd + h0 + n] =
                         from_f<T>(activate<ACT>(h));
                   dact[r * kHidChunk + n] = activate_grad<ACT>(h);
                 });
    // dh = (g W2)[:, chunk] * act'(h), rounded; to scratch
    gemm_rows_kn<T>(gs, Op, O, w2 + h0, Hd, nh, wtile,
                    [&](int r, int n, float v) {
                      const float dh =
                          round_to<T>(v * dact[r * kHidChunk + n]);
                      dhs[r * kHidChunk + n] = dh;
                      if (r0 + r < N)
                        dh_out[(r0 + r) * Hd + h0 + n] = from_f<T>(dh);
                    });
    // dy += dh[:, chunk] W1[chunk, :]
    gemm_rows_kn<T>(dhs, kHidChunk, nh, w1 + (size_t)h0 * C, C, C, wtile,
                    [&](int r, int n, float v) { dys[r * C + n] += v; });
  }
  __syncthreads();
  ln_backward_rows<T>(x, dys, stat, lnw, residual ? gs : nullptr, Op, dx,
                      part ? part + (size_t)blockIdx.x * 2 * C : nullptr,
                      r0, N, C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_linear_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const T* __restrict__ lnw, const T* __restrict__ lnb,
    const T* __restrict__ w, T* __restrict__ dx, T* __restrict__ y_out,
    float* __restrict__ part, int N, int K, int O, float eps) {
  extern __shared__ float smem[];
  const int Op = round_up_kc(O);
  float* xs = smem;                  // [16][K] LN(x), then dL/dy
  float* gs = xs + kRows * K;        // [16][Op] g, zero-padded
  float* stat = gs + kRows * Op;     // [16][2]
  float* wtile = stat + 2 * kRows;

  const long long r0 = (long long)blockIdx.x * kRows;
  load_rows(x, xs, r0, N, K);
  load_rows(g, gs, r0, N, O, Op);
  __syncthreads();
  layer_norm_rows<T>(xs, K, K, lnw, lnb, eps, stat);
  __syncthreads();
  store_rows(xs, y_out, r0, N, K);
  // dy = g W, over the LN output (gemm_rows_kn syncs before its first
  // tile, after every thread has stored its part of y)
  gemm_rows_kn<T>(gs, Op, O, w, K, K, wtile,
                  [&](int r, int n, float v) { xs[r * K + n] = v; });
  __syncthreads();
  ln_backward_rows<T>(x, xs, stat, lnw, nullptr, 0, dx,
                      part + (size_t)blockIdx.x * 2 * K, r0, N, K);
}

template <typename T, int ACT>
cudaError_t launch_two_matmul_bwd(const void* x, const void* g,
                                  const void* lnw, const void* lnb,
                                  const void* w1, const void* b1,
                                  const void* w2, void* dx, void* y, void* a,
                                  void* dh, float* part, int N, int C, int Hd,
                                  int O, int residual, float eps,
                                  cudaStream_t stream) {
  if (C % kKC || Hd % kKC || (residual && O != C) || N <= 0 || O <= 0 ||
      (lnw && (!y || !part)))
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * kRows * C + kRows * round_up_kc(O) +
                       2 * kRows * kHidChunk + 2 * kRows + kWTileFloats);
  cudaError_t err = prepare_smem(two_matmul_bwd_kernel<T, ACT>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  two_matmul_bwd_kernel<T, ACT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<T*>(dx), static_cast<T*>(y),
      static_cast<T*>(a), static_cast<T*>(dh), part, N, C, Hd, O, residual,
      eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_linear_bwd(const void* x, const void* g,
                                 const void* lnw, const void* lnb,
                                 const void* w, void* dx, void* y,
                                 float* part, int N, int K, int O, float eps,
                                 cudaStream_t stream) {
  if (K % kKC || N <= 0 || O <= 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kRows * K + kRows * round_up_kc(O) +
                                       2 * kRows + kWTileFloats);
  cudaError_t err = prepare_smem(ln_linear_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kRows - 1) / kRows;
  ln_linear_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(w), static_cast<T*>(dx), static_cast<T*>(y),
      part, N, K, O, eps);
  return cudaGetLastError();
}

namespace tc {

constexpr int kBwdStages = 4;   // ring stages of the hidden kernel
constexpr int kDyStages = 3;    // ring stages of the dy kernel

// grid (64-row tiles, tiles of 128 hidden units): a and dh of the tile.
// y: LN(x) (or x without LN), g: dL/dout.
template <int ACT>
__global__ void __launch_bounds__(kWg) mlp_bwd_hidden_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ g,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2, bf16* __restrict__ a_out,
    bf16* __restrict__ dh_out, int N, int C, int Hd, int O) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BN = 128;
  constexpr uint32_t kB = BN * 128;        // weight tile, either major
  constexpr uint32_t kStage = kB + kSub;   // + the rows' 64 x 64 operand
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* staged = sm + kBwdStages * kStage;   // 64 x 128 bf16 out
  const uint32_t ring = smem_u32(sm);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int ktc = (C + 63) / 64, kto = (O + 63) / 64;
  const int row = frag_row();

  float acc[BN / 2];
  float dact[BN / 2];    // act'(h) of this thread's elements
  auto fetch = [&](int t, uint32_t st) {
    if (t < ktc) {         // W1[n0 ..][64 t ..] and y[rows][64 t ..]
      load_tile(st, w1, C, n0, Hd, t * 64, C, BN);
      load_tile(st + kB, y, C, r0, N, t * 64, C, kBM);
    } else {               // W2[64 j ..][n0 ..] as two sub-tiles, g[rows][64 j ..]
      const int j = t - ktc;
      load_tile(st, w2, Hd, j * 64, O, n0, Hd, 64);
      load_tile(st + kSub, w2, Hd, j * 64, O, n0 + 64, Hd, 64);
      load_tile(st + kB, g, O, r0, N, j * 64, O, kBM);
    }
  };
  auto use = [&](int t, uint32_t st) {
    if (t < ktc) {
      mma_tile<BN, 0, 0>(acc, st + kB, st, min(4, (C - t * 64) / 16), t == 0);
      if (t + 1 < ktc) {
        wgmma_wait<1>();
        return;
      }
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int fc = frag_col(jj);
        float bias0 = 0.f, bias1 = 0.f;
        if (n0 + fc < Hd) {
          bias0 = to_f(b1[n0 + fc]);
          bias1 = to_f(b1[n0 + fc + 1]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ha = round_to<bf16>(acc[4 * jj + 2 * e] + bias0);
          const float hb = round_to<bf16>(acc[4 * jj + 2 * e + 1] + bias1);
          float aa, ab;
          activate_both<ACT>(ha, aa, dact[4 * jj + 2 * e]);
          activate_both<ACT>(hb, ab, dact[4 * jj + 2 * e + 1]);
          *reinterpret_cast<uint32_t*>(staged + (fc >> 6) * kSub +
                                       swz(row + 8 * e, fc & 63)) =
              pack_bf16(aa, ab);
        }
      }
      __syncthreads();
      store_staged(staged, a_out, Hd, r0, N, n0, Hd, BN / 64);
    } else {
      const int j = t - ktc;
      mma_tile<BN, 0, 1>(acc, st + kB, st, min(4, (O - j * 64 + 15) / 16),
                         j == 0);
      if (j + 1 < kto) {
        wgmma_wait<1>();
        return;
      }
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int fc = frag_col(jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<uint32_t*>(staged + (fc >> 6) * kSub +
                                       swz(row + 8 * e, fc & 63)) =
              pack_bf16(acc[4 * jj + 2 * e] * dact[4 * jj + 2 * e],
                        acc[4 * jj + 2 * e + 1] * dact[4 * jj + 2 * e + 1]);
        }
      }
      __syncthreads();
      store_staged(staged, dh_out, Hd, r0, N, n0, Hd, BN / 64);
    }
  };
  stream_tiles<kBwdStages>(ring, kStage, ktc + kto, fetch, use);
}

// grid (64-row tiles, tiles of BN columns of C, splits of Hd): the split's
// dy = dh[:, split] W1[split, :] in fp32 to dyp[split][N][C]; kts 64-deep
// tiles of Hd per split.  Hd % 8 == 0: a last step of fewer than 16 hidden
// units reads the tiles' zero fill.
template <int BN>
__device__ __forceinline__ void dy_tile(const bf16* __restrict__ dh,
                                        const bf16* __restrict__ w1,
                                        float* __restrict__ dyp, int N, int C,
                                        int Hd, int kts) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kB = b_tile_bytes<BN, 1>();
  constexpr uint32_t kStage = kB + kSub;
  const uint32_t ring = smem_u32(align_smem(smem_raw));

  const long long r0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kts;
  const int T = min(kts, (Hd + 63) / 64 - kt0);
  const int row = frag_row();

  float acc[BN / 2];
  auto fetch = [&](int t, uint32_t st) {
    const int k0 = (kt0 + t) * 64;
#pragma unroll
    for (int s = 0; s < BN / 64; ++s)
      load_tile(st + s * kSub, w1, C, k0, Hd, n0 + 64 * s, C, 64);
    load_tile(st + kB, dh, Hd, r0, N, k0, Hd, kBM);
  };
  auto use = [&](int t, uint32_t st) {
    const int k0 = (kt0 + t) * 64;
    mma_tile<BN, 0, 1>(acc, st + kB, st, min(4, (Hd - k0 + 15) / 16), t == 0);
    if (t + 1 < T) {
      wgmma_wait<1>();
      return;
    }
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = n0 + frag_col(jj);
      if (col >= C) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long r = r0 + row + 8 * e;
        if (r < N)
          *reinterpret_cast<float2*>(
              dyp + ((size_t)blockIdx.z * N + r) * C + col) =
              make_float2(acc[4 * jj + 2 * e], acc[4 * jj + 2 * e + 1]);
      }
    }
  };
  stream_tiles<kDyStages>(ring, kStage, T, fetch, use);
}

template <int BN>
__global__ void __launch_bounds__(kWg) mlp_bwd_dy_kernel(
    const bf16* __restrict__ dh, const bf16* __restrict__ w1,
    float* __restrict__ dyp, int N, int C, int Hd, int kts) {
  dy_tile<BN>(dh, w1, dyp, N, C, Hd, kts);
}

// K11: dy = g W, with g (N, O) as dh and W (O, K) as w1.
template <int BN>
__global__ void __launch_bounds__(kWg) ln_linear_bwd_dy_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ w,
    float* __restrict__ dyp, int N, int K, int O, int kts) {
  dy_tile<BN>(g, w, dyp, N, K, O, kts);
}

// 16 rows per CTA: dy = the splits' partial sums added in split order, then
// dx = LN^T(dy) [+ g] and the rows' dlnw | dlnb partial (ln_backward_rows).
__device__ __forceinline__ void finish_rows(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    const bf16* __restrict__ lnw, const float* __restrict__ stat,
    const float* __restrict__ dyp, bf16* __restrict__ dx,
    float* __restrict__ part, int N, int C, int splits, int residual) {
  extern __shared__ __align__(16) float fsmem[];
  float* dys = fsmem;                                   // [16][C]
  float* gs = dys + kRows * C;                          // [16][C], residual
  float* st = gs + (residual ? kRows * C : 0);          // [16][2]
  const long long r0 = (long long)blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const long long r = r0 + rr;
    for (int c = lane * 4; c < C; c += 128) {   // four columns per lane
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv = v;
      if (r < N) {
        for (int s = 0; s < splits; ++s) {
          const float4 p = *reinterpret_cast<const float4*>(
              dyp + ((size_t)s * N + r) * C + c);
          v.x += p.x;
          v.y += p.y;
          v.z += p.z;
          v.w += p.w;
        }
        if (residual) {
          const uint2 raw = *reinterpret_cast<const uint2*>(g + r * C + c);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          gv = make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
        }
      }
      *reinterpret_cast<float4*>(dys + rr * C + c) = v;
      if (residual) *reinterpret_cast<float4*>(gs + rr * C + c) = gv;
    }
  }
  if (lnw && threadIdx.x < 2 * kRows)
    st[threadIdx.x] =
        r0 + threadIdx.x / 2 < N ? stat[r0 * 2 + threadIdx.x] : 0.f;
  __syncthreads();
  ln_backward_rows<bf16>(x, dys, st, lnw, residual ? gs : nullptr, C, dx,
                         part ? part + (size_t)blockIdx.x * 2 * C : nullptr,
                         r0, N, C);
}

__global__ void __launch_bounds__(kThreads) mlp_bwd_finish_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    const bf16* __restrict__ lnw, const float* __restrict__ stat,
    const float* __restrict__ dyp, bf16* __restrict__ dx,
    float* __restrict__ part, int N, int C, int splits, int residual) {
  finish_rows(x, g, lnw, stat, dyp, dx, part, N, C, splits, residual);
}

// K11: no residual (g is not read).
__global__ void __launch_bounds__(kThreads) ln_linear_bwd_finish_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const float* __restrict__ stat, const float* __restrict__ dyp,
    bf16* __restrict__ dx, float* __restrict__ part, int N, int K,
    int splits) {
  finish_rows(x, nullptr, lnw, stat, dyp, dx, part, N, K, splits, 0);
}

__global__ void __launch_bounds__(kThreads) ln_linear_bwd_ln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const bf16* __restrict__ lnb, bf16* __restrict__ y,
    float* __restrict__ stat, int N, int C, float eps) {
  ln_rows(x, lnw, lnb, y, stat, N, C, eps);
}

// Launch a dy kernel (mlp_bwd_dy_kernel<bn> or ln_linear_bwd_dy_kernel<bn>)
// over grid (row tiles, tiles of bn columns of C, splits).
template <typename Kernel>
cudaError_t launch_dy(Kernel kernel, int bn, const bf16* dh, const bf16* w1,
                      float* dyp, int N, int C, int Hd, int kts, int splits,
                      cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)kDyStages * ((bn / 64) * kSub + kSub);
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM, (C + bn - 1) / bn, splits);
  kernel<<<grid, kWg, smem, stream>>>(dh, w1, dyp, N, C, Hd, kts);
  return cudaGetLastError();
}

// kts 64-deep tiles per split, or 0 when dy_splits does not put every tile
// of Hd into exactly one non-empty split.
inline int dy_tiles_per_split(int Hd, int dy_splits) {
  const int kt = (Hd + 63) / 64;
  if (dy_splits < 1 || dy_splits > kt) return 0;
  const int kts = (kt + dy_splits - 1) / dy_splits;
  return (kt + kts - 1) / kts == dy_splits ? kts : 0;
}

template <int ACT>
cudaError_t launch_two_matmul_bwd_tc(const bf16* x, const bf16* g,
                                     const bf16* lnw, const bf16* lnb,
                                     const bf16* w1, const bf16* b1,
                                     const bf16* w2, bf16* dx, bf16* y,
                                     bf16* a, bf16* dh, float* part,
                                     float* stat, float* dyp, int N, int C,
                                     int Hd, int O, int residual, float eps,
                                     int dy_splits, cudaStream_t stream) {
  const int kts = dy_tiles_per_split(Hd, dy_splits);
  if (C % kKC || Hd % kKC || O % 8 || (residual && O != C) || N <= 0 ||
      O <= 0 || !dyp || (lnw && (!y || !part || !stat)) || !kts)
    return cudaErrorInvalidValue;
  cudaError_t err;
  const bf16* ysrc = x;
  if (lnw) {
    err = launch_ln_rows(x, lnw, lnb, y, stat, N, C, eps, stream);
    if (err != cudaSuccess) return err;
    ysrc = y;
  }
  {
    const size_t smem = 1024 + (size_t)kBwdStages * (128 * 128 + kSub) +
                        2 * kSub;
    err = prepare_smem(mlp_bwd_hidden_kernel<ACT>, smem);
    if (err != cudaSuccess) return err;
    mlp_bwd_hidden_kernel<ACT>
        <<<dim3((N + kBM - 1) / kBM, (Hd + 127) / 128), kWg, smem, stream>>>(
            ysrc, g, w1, b1, w2, a, dh, N, C, Hd, O);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = C % 192 == 0 ? launch_dy(mlp_bwd_dy_kernel<192>, 192, dh, w1, dyp, N,
                                 C, Hd, kts, dy_splits, stream)
                     : launch_dy(mlp_bwd_dy_kernel<128>, 128, dh, w1, dyp, N,
                                 C, Hd, kts, dy_splits, stream);
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * ((residual ? 2 : 1) * kRows * C + 2 * kRows);
  err = prepare_smem(mlp_bwd_finish_kernel, smem);
  if (err != cudaSuccess) return err;
  mlp_bwd_finish_kernel<<<(N + kRows - 1) / kRows, kThreads, smem, stream>>>(
      x, g, lnw, stat, dyp, dx, part, N, C, dy_splits, residual);
  return cudaGetLastError();
}

// K11's token pass: stat (N, 2) and dyp (dy_splits, N, K) are fp32 scratch,
// y (N, K) the LN output that dW = g^T y reads, part one dlnw | dlnb row per
// 16 rows.
inline cudaError_t launch_ln_linear_bwd_tc(const bf16* x, const bf16* g,
                                           const bf16* lnw, const bf16* lnb,
                                           const bf16* w, bf16* dx, bf16* y,
                                           float* part, float* stat,
                                           float* dyp, int N, int K, int O,
                                           float eps, int dy_splits,
                                           cudaStream_t stream) {
  const int kts = dy_tiles_per_split(O, dy_splits);
  if (K % kKC || O % 8 || N <= 0 || O <= 0 || !y || !part || !stat || !dyp ||
      !kts)
    return cudaErrorInvalidValue;
  cudaError_t err = launch_ln_rows(x, lnw, lnb, y, stat, N, K, eps, stream,
                                   ln_linear_bwd_ln_kernel);
  if (err != cudaSuccess) return err;
  err = K % 192 == 0 ? launch_dy(ln_linear_bwd_dy_kernel<192>, 192, g, w, dyp,
                                 N, K, O, kts, dy_splits, stream)
                     : launch_dy(ln_linear_bwd_dy_kernel<128>, 128, g, w, dyp,
                                 N, K, O, kts, dy_splits, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (kRows * K + 2 * kRows);
  err = prepare_smem(ln_linear_bwd_finish_kernel, smem);
  if (err != cudaSuccess) return err;
  ln_linear_bwd_finish_kernel<<<(N + kRows - 1) / kRows, kThreads, smem,
                                stream>>>(x, lnw, stat, dyp, dx, part, N, K,
                                          dy_splits);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// fp32: the FMA kernel (part: one dlnw | dlnb row per 16 rows); stat, dyp
// and dy_splits are not read.  bf16: the four tensor-core launches; stat
// (N, 2) and dyp (dy_splits, N, C) are fp32 scratch, part as for fp32.
extern "C" int tulip_two_matmul_bwd(int dtype, int act, const void* x,
                                    const void* g, const void* lnw,
                                    const void* lnb, const void* w1,
                                    const void* b1, const void* w2, void* dx,
                                    void* y, void* a, void* dh, void* part,
                                    void* stat, void* dyp, int N, int C,
                                    int Hd, int O, int residual, float eps,
                                    int dy_splits, void* stream) {
  using tulip::kGelu;
  using tulip::kLeaky;
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
#define TULIP_TM_BWD(T, ACT)                                                \
  return tulip::launch_two_matmul_bwd<T, ACT>(x, g, lnw, lnb, w1, b1, w2,  \
                                              dx, y, a, dh, p, N, C, Hd, O, \
                                              residual, eps, s)
  if (dtype == 0 && act == kGelu) TULIP_TM_BWD(float, kGelu);
  if (dtype == 0 && act == kLeaky) TULIP_TM_BWD(float, kLeaky);
#undef TULIP_TM_BWD
  if (dtype != 1) return cudaErrorInvalidValue;
#define TULIP_TM_BWD_TC(ACT)                                                 \
  return tulip::tc::launch_two_matmul_bwd_tc<ACT>(                           \
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),              \
      static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),          \
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),            \
      static_cast<const bf16*>(w2), static_cast<bf16*>(dx),                  \
      static_cast<bf16*>(y), static_cast<bf16*>(a), static_cast<bf16*>(dh),  \
      p, static_cast<float*>(stat), static_cast<float*>(dyp), N, C, Hd, O,   \
      residual, eps, dy_splits, s)
  if (act == kGelu) TULIP_TM_BWD_TC(kGelu);
  if (act == kLeaky) TULIP_TM_BWD_TC(kLeaky);
#undef TULIP_TM_BWD_TC
  return cudaErrorInvalidValue;
}

// fp32: the FMA kernel; stat, dyp and dy_splits are not read.  bf16: the
// three tensor-core launches.  part: one dlnw | dlnb row per 16 rows.
extern "C" int tulip_ln_linear_bwd(int dtype, const void* x, const void* g,
                                   const void* lnw, const void* lnb,
                                   const void* w, void* dx, void* y,
                                   void* part, void* stat, void* dyp, int N,
                                   int K, int O, float eps, int dy_splits,
                                   void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return tulip::launch_ln_linear_bwd<float>(x, g, lnw, lnb, w, dx, y, p, N,
                                              K, O, eps, s);
  if (dtype == 1)
    return tulip::tc::launch_ln_linear_bwd_tc(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),
        static_cast<const bf16*>(w), static_cast<bf16*>(dx),
        static_cast<bf16*>(y), p, static_cast<float*>(stat),
        static_cast<float*>(dyp), N, K, O, eps, dy_splits, s);
  return cudaErrorInvalidValue;
}
