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
// Bound on the H100: the MLP does 16*C^2 FLOPs per token against 8C^2
// weights; at 16 tokens per CTA each weight element read feeds 16 MACs,
// and the token rows are read and written once from HBM; far below the
// tensor-core roofline.  Measured (PERF.md): with fp32 FMA on the CUDA
// cores, the product loop's shared-memory loads (4 per 4 FMAs) bound the
// wide-N launches; the deep stages (C >= 384, 16-512 CTAs at batch 1-8)
// wait on one weight tile at a time from HBM.
// Design: one CTA per 16 token rows; the LN output and a [16][O] fp32
// accumulator stay in shared memory while the hidden dimension is walked in
// chunks of 64, so the (N, Hd) hidden activation never reaches HBM (the
// point of the TPU kernel).  Tensor cores (wgmma) are later work.
#include "common.cuh"

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

}  // namespace tulip

extern "C" int tulip_two_matmul(int dtype, int act, const void* x, void* out,
                                const void* lnw, const void* lnb,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, int N, int C,
                                int Hd, int O, int residual, float eps,
                                void* stream) {
  using tulip::kGelu;
  using tulip::kLeaky;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && act == kGelu)
    return tulip::launch_two_matmul<float, kGelu>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
  if (dtype == 0 && act == kLeaky)
    return tulip::launch_two_matmul<float, kLeaky>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
  if (dtype == 1 && act == kGelu)
    return tulip::launch_two_matmul<__nv_bfloat16, kGelu>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
  if (dtype == 1 && act == kLeaky)
    return tulip::launch_two_matmul<__nv_bfloat16, kLeaky>(
        x, out, lnw, lnb, w1, b1, w2, b2, N, C, Hd, O, residual, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" int tulip_ln_linear(int dtype, const void* x, void* out,
                               const void* lnw, const void* lnb,
                               const void* w, int N, int K, int O, float eps,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::launch_ln_linear<float>(x, out, lnw, lnb, w, N, K, O, eps,
                                          s);
  if (dtype == 1)
    return tulip::launch_ln_linear<__nv_bfloat16>(x, out, lnw, lnb, w, N, K,
                                                  O, eps, s);
  return cudaErrorInvalidValue;
}
