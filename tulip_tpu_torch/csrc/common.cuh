// Shared building blocks of the tulip_tpu_torch kernels: the CTA shape of
// the row kernels (kRows = 16 token rows, one 2x8 attention window, per
// CTA of 256 threads), rounding to the activation dtype, warp sums, the
// activations and the shared-memory opt-in.  The products of the MLP and
// patch-merging kernels (K3, K4, K10, K11, the weight-gradient product)
// and of the attention half-block run on the tensor cores (mma.cuh), in
// bf16 or, for fp32, in split TF32; the FMA product core that the fp32
// MLP parity kernels shared went with them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tulip {

constexpr int kThreads = 256;
constexpr int kRows = 16;              // token rows per CTA
constexpr int kKC = 32;                // widths of C, Hd, K: multiples of it
constexpr size_t kMaxSmem = 232448;    // 227 KB per block on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// v rounded to the activation dtype T, returned as fp32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

enum Act { kGelu = 0, kLeaky = 1 };

// exact (erf) GELU, or leaky ReLU with slope 0.01
template <int ACT> __device__ __forceinline__ float activate(float h) {
  if (ACT == kGelu) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  return h >= 0.f ? h : 0.01f * h;
}

// d activate / dh at h (leaky: slope 1 at h == 0, as autograd of the
// forward's h >= 0 branch)
template <int ACT> __device__ __forceinline__ float activate_grad(float h) {
  if (ACT == kGelu) {
    const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    return cdf + h * expf(-0.5f * h * h) * 0.39894228040143268f;
  }
  return h >= 0.f ? 1.f : 0.01f;
}

// a = activate(h) and da = activate_grad(h) with the GELU's erf taken once.
template <int ACT>
__device__ __forceinline__ void activate_both(float h, float& a, float& da) {
  if (ACT == kGelu) {
    const float e = erff(h * 0.70710678118654752f);
    a = 0.5f * h * (1.f + e);
    da = 0.5f * (1.f + e) + h * expf(-0.5f * h * h) * 0.39894228040143268f;
  } else {
    a = activate<ACT>(h);
    da = activate_grad<ACT>(h);
  }
}

// Opt in to > 48 KB of dynamic shared memory, or report it cannot fit.
template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tulip
