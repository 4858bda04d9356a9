// Backward of the fused two-matmul (K10) and of LN + matmul (K11): the
// token-parallel pass.
//
// tulip_two_matmul_bwd replaces tulip_tpu/ops/pallas/mlp.py:_bwd_kernel.
// With y = [LN](x), h = y W1^T + b1, a = act(h), out = a W2^T [+ b2] [+ x]
// and g = dL/dout, per 16-row tile it recomputes y and h chunk by chunk
// (64 hidden units at a time) and computes
//   da = g W2,  dh = da * act'(h),  dy = dh W1,  dx = LN^T(dy) [+ g],
// writing dx, and to HBM scratch y (N, C), a (N, Hd) and dh (N, Hd) plus
// the tile's dlnw | dlnb partial sums.  tulip_ln_linear_bwd replaces
// mlp.py:_kernel_ln_mm_bwd (out = LN(x) W^T): dy = g W, dx = LN^T(dy), y
// to scratch and the dlnw | dlnb partials.
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
// Bound on the H100: per token 2 C Hd (h) + 2 O Hd (da) + 2 Hd C (dy) FMAs
// on the CUDA cores, against the weights streamed tile by tile as in the
// forward (mlp.cu); so the pass costs about 1.5 forwards, and the deep
// stages wait on weight tiles from HBM.  Tensor cores, weight prefetch and
// a split of the deep stages over more CTAs are later work.
#include "common.cuh"

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

}  // namespace tulip

extern "C" int tulip_two_matmul_bwd(int dtype, int act, const void* x,
                                    const void* g, const void* lnw,
                                    const void* lnb, const void* w1,
                                    const void* b1, const void* w2, void* dx,
                                    void* y, void* a, void* dh, void* part,
                                    int N, int C, int Hd, int O,
                                    int residual, float eps, void* stream) {
  using tulip::kGelu;
  using tulip::kLeaky;
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
#define TULIP_TM_BWD(T, ACT)                                                \
  return tulip::launch_two_matmul_bwd<T, ACT>(x, g, lnw, lnb, w1, b1, w2,  \
                                              dx, y, a, dh, p, N, C, Hd, O, \
                                              residual, eps, s)
  if (dtype == 0 && act == kGelu) TULIP_TM_BWD(float, kGelu);
  if (dtype == 0 && act == kLeaky) TULIP_TM_BWD(float, kLeaky);
  if (dtype == 1 && act == kGelu) TULIP_TM_BWD(__nv_bfloat16, kGelu);
  if (dtype == 1 && act == kLeaky) TULIP_TM_BWD(__nv_bfloat16, kLeaky);
#undef TULIP_TM_BWD
  return cudaErrorInvalidValue;
}

extern "C" int tulip_ln_linear_bwd(int dtype, const void* x, const void* g,
                                   const void* lnw, const void* lnb,
                                   const void* w, void* dx, void* y,
                                   void* part, int N, int K, int O, float eps,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return tulip::launch_ln_linear_bwd<float>(x, g, lnw, lnb, w, dx, y, p, N,
                                              K, O, eps, s);
  if (dtype == 1)
    return tulip::launch_ln_linear_bwd<__nv_bfloat16>(x, g, lnw, lnb, w, dx,
                                                      y, p, N, K, O, eps, s);
  return cudaErrorInvalidValue;
}
