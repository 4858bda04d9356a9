// LayerNorm over the last axis of an (N, C) token matrix, forward and
// backward.
//
// Replaces: tulip_tpu/ops/pallas/ln.py:_fwd_kernel and ln.py:_bwd_kernel
// (the opt-in norm1 of the training block, layer_norm_vjp).
//
// Forward, per row: y = (x - mean) * rstd * w + b with fp32 mean, variance
// (two-pass, around the mean) and affine, cast back to the activation
// dtype: the rounding points of ln.py:45-50 and of models/layers.py
// layer_norm.  Backward, per row, from x, w and the upstream gradient g
// only (mean and rstd are recomputed, nothing else was saved):
//   xh = (x - mean) * rstd,  t = g * w
//   dx = rstd * (t - mean_c(t) - xh * mean_c(t * xh))
//   dw = sum_rows g * xh,  db = sum_rows g            (fp32)
//
// Bound on the H100: bytes.  The forward reads and writes N*C activations
// once (50 MB in bf16 at 131,072 x 96), the backward reads two and writes
// one; there are about 8 FLOPs per element.
// Design: one warp per token row, lanes strided over the columns (lane l
// holds columns l, l + 32, ...: C = 96 is three per lane, no ragged tail),
// shuffle reductions for the row statistics.  A row is a few hundred bytes,
// so the second and third pass over it hit L1; the row is not staged.  The
// TPU kernel accumulates dw / db into one VMEM block across its in-order
// grid; CUDA blocks run in no order, so here each warp sums its rows' dw /
// db terms into its own shared-memory row (lane-private columns: no
// atomics), the block adds its warps in a fixed order and writes one
// (2, C) fp32 partial per block, and tulip_colsum (reduce.cu) sums the
// partials in a fixed order: the result is deterministic.  Vector loads
// and several rows per warp are later work.
#include "common.cuh"

namespace tulip {

constexpr int kLnWarps = kThreads / 32;   // rows in flight per block

// mean and 1/std of one row, by the whole warp
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int C,
                                          int lane, float eps, float& mean,
                                          float& rstd) {
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += to_f(xr[c]);
  mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    sq += d * d;
  }
  rstd = rsqrtf(warp_sum(sq) / C + eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, T* __restrict__ y, long long N, int C,
    float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kLnWarps + warp;
  if (r >= N) return;   // whole warps leave together; no block barrier below
  const T* xr = x + r * C;
  T* yr = y + r * C;
  float mean, rstd;
  row_stats(xr, C, lane, eps, mean, rstd);
  for (int c = lane; c < C; c += 32)
    yr[c] = from_f<T>((to_f(xr[c]) - mean) * rstd * w[c] + b[c]);
}

// part: (gridDim.x, 2, C) fp32, block i's sums of g * xh and of g over its
// rows [i * rows_per_block, (i + 1) * rows_per_block)
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
    long long N, int C, int rows_per_block, float eps) {
  extern __shared__ float smem[];   // [kLnWarps][2][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dw = smem + (size_t)warp * 2 * C;
  float* db = dw + C;
  for (int c = lane; c < C; c += 32) {
    dw[c] = 0.f;
    db[c] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  for (long long r = r0 + warp; r < r1; r += kLnWarps) {
    const T* xr = x + r * C;
    const T* gr = g + r * C;
    T* dxr = dx + r * C;
    float mean, rstd;
    row_stats(xr, C, lane, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = to_f(gr[c]);
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float t = gv * w[c];
      s1 += t;
      s2 += t * xh;
      dw[c] += gv * xh;
      db[c] += gv;
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float t = to_f(gr[c]) * w[c];
      dxr[c] = from_f<T>(rstd * (t - m1 - xh * m2));
    }
  }
  __syncthreads();
  float* out = part + (size_t)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int wp = 0; wp < kLnWarps; ++wp) t += smem[(size_t)wp * 2 * C + i];
    out[i] = t;
  }
}

template <typename T>
cudaError_t launch_ln_fwd(const void* x, const float* w, const float* b,
                          void* y, long long N, int C, float eps,
                          cudaStream_t stream) {
  if (N <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long blocks = (N + kLnWarps - 1) / kLnWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ln_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), N, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const float* w, const void* g,
                          void* dx, float* part, long long N, int C,
                          int rows_per_block, float eps,
                          cudaStream_t stream) {
  if (N <= 0 || C <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kLnWarps * 2 * (size_t)C;
  cudaError_t err = prepare_smem(ln_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(g),
      static_cast<T*>(dx), part, N, C, rows_per_block, eps);
  return cudaGetLastError();
}

}  // namespace tulip

// dtype of x, y, g and dx: 0 fp32, 1 bf16; w, b and part are fp32
extern "C" int tulip_ln_fwd(int dtype, const void* x, const void* w,
                            const void* b, void* y, long long N, int C,
                            float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(b);
  if (dtype == 0) return tulip::launch_ln_fwd<float>(x, wf, bf, y, N, C, eps, s);
  if (dtype == 1)
    return tulip::launch_ln_fwd<__nv_bfloat16>(x, wf, bf, y, N, C, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" int tulip_ln_bwd(int dtype, const void* x, const void* w,
                            const void* g, void* dx, void* part, long long N,
                            int C, int rows_per_block, float eps,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return tulip::launch_ln_bwd<float>(x, wf, g, dx, p, N, C, rows_per_block,
                                       eps, s);
  if (dtype == 1)
    return tulip::launch_ln_bwd<__nv_bfloat16>(x, wf, g, dx, p, N, C,
                                               rows_per_block, eps, s);
  return cudaErrorInvalidValue;
}
