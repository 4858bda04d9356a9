// Shared building blocks of the tulip_tpu_torch kernels.
//
// Every row kernel works on a tile of kRows = 16 token rows per CTA of 256
// threads (one 2x8 attention window, or 16 consecutive rows of a token
// matrix).  Rows are staged in shared memory as fp32; products run on the
// CUDA cores in fp32 through gemm_rows() (x W^T) and gemm_rows_kn() (g W),
// which stream 64 x 32 tiles of a torch-layout (out, in) weight from global
// memory through shared memory, one tile at a time (no prefetch).  Values
// the reference rounds to the activation dtype (LN output, q/k/v,
// probabilities, hidden activations) are rounded with round_to<T>() at the
// same points.
// The bf16 MLP and patch-merging kernels (K3, K4, K10, K11 and the
// weight-gradient product) and the bf16 attention half-block (K1, K2, K12,
// K13) do not use this product core: theirs is mma.cuh, 64 rows per CTA on
// the tensor cores with prefetched tiles.  Every fp32 instantiation runs on
// the core below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tulip {

constexpr int kThreads = 256;
constexpr int kRows = 16;              // token rows per CTA
constexpr int kNT = 64;                // output columns per weight tile
constexpr int kKC = 32;                // reduction depth per weight tile
constexpr int kWStride = kKC + 1;      // padded: conflict-free column reads
constexpr int kWTileFloats = kNT * kWStride;
constexpr int kHidChunk = 64;          // hidden units per MLP step
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

// Stage rows [r0, r0 + 16) of x (N x C, row stride C) into s (row stride
// ld >= C) as fp32; zero beyond N and in columns [C, ld).
template <typename T>
__device__ void load_rows(const T* x, float* s, long long r0, int N, int C,
                          int ld) {
  for (int i = threadIdx.x; i < kRows * ld; i += kThreads) {
    const long long r = r0 + i / ld;
    const int c = i % ld;
    s[i] = (r < N && c < C) ? to_f(x[r * C + c]) : 0.f;
  }
}
template <typename T>
__device__ void load_rows(const T* x, float* s, long long r0, int N, int C) {
  load_rows(x, s, r0, N, C, C);
}

// LayerNorm in place over the kRows rows of s (row stride ld, width C),
// fp32 statistics, result rounded to T.  One warp per row.  With stat, row
// r's mean and 1/std go to stat[2r], stat[2r + 1] (for the backward).
template <typename T>
__device__ void layer_norm_rows(float* s, int ld, int C, const T* w,
                                const T* b, float eps,
                                float* stat = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = s + r * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    if (stat && lane == 0) {
      stat[2 * r] = mean;
      stat[2 * r + 1] = rstd;
    }
    for (int c = lane; c < C; c += 32)
      row[c] = round_to<T>((row[c] - mean) * rstd * to_f(w[c]) + to_f(b[c]));
  }
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

// Weight row of output column n: row0 + (n / group) * gstride + n % group.
struct RowMap {
  int row0, group, gstride;
  __device__ __forceinline__ int operator()(int n) const {
    return row0 + (n / group) * gstride + n % group;
  }
};
__device__ __forceinline__ RowMap identity_rows() {
  return RowMap{0, 1 << 30, 0};
}

// The product core of gemm_rows / gemm_rows_kn: out[r][n] = sum_{k < K}
// A[r][k] * Wt(n, k) for r < kRows, n < N, handed to epi(r, n, value).
// A: fp32 shared memory, row stride lda; K is walked in steps of kKC, so A
// must hold zeros (not garbage) in [K, roundup(K, kKC)).  fill(n0, k0)
// stages the weight tile Wt(n0 + n, k0 + k) into wtile[n * kWStride + k],
// zero outside N x K.  Every thread must call this; it synchronises the
// block before it first writes wtile, so shared inputs written before the
// call are visible, and epi may write shared memory that no other thread
// reads during the call.
// Thread mapping: warp w owns rows 2w, 2w+1; lane l owns columns l, l+32.
template <typename Fill, typename Epi>
__device__ void gemm_tiles(const float* A, int lda, int K, int N,
                           float* wtile, Fill fill, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 2;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();
      fill(n0, k0);
      __syncthreads();
      const float* a0p = A + r0 * lda + k0;
      const float* a1p = a0p + lda;
      const float* w0p = wtile + lane * kWStride;
      const float* w1p = w0p + 32 * kWStride;
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        const float a0 = a0p[k], a1 = a1p[k], w0 = w0p[k], w1 = w1p[k];
        acc00 += a0 * w0;
        acc01 += a0 * w1;
        acc10 += a1 * w0;
        acc11 += a1 * w1;
      }
    }
    const int n_a = n0 + lane, n_b = n0 + lane + 32;
    if (n_a < N) {
      epi(r0, n_a, acc00);
      epi(r0 + 1, n_a, acc10);
    }
    if (n_b < N) {
      epi(r0, n_b, acc01);
      epi(r0 + 1, n_b, acc11);
    }
  }
}

// out[r][n] = sum_{k < K} A[r][k] * W[map(n)][k]: A times the transpose of
// a torch-layout (out, in) weight W (row stride ldw), as in x W^T.
// K % kKC == 0.  Tile loads run along W's rows (coalesced in k).
template <typename T, typename Epi>
__device__ void gemm_rows(const float* A, int lda, int K, const T* W,
                          int ldw, RowMap map, int N, float* wtile, Epi epi) {
  gemm_tiles(A, lda, K, N, wtile, [&](int n0, int k0) {
    for (int i = threadIdx.x; i < kNT * kKC; i += kThreads) {
      const int n = i / kKC, k = i % kKC;
      float v = 0.f;
      if (n0 + n < N && k0 + k < K)
        v = to_f(W[(size_t)map(n0 + n) * ldw + k0 + k]);
      wtile[n * kWStride + k] = v;
    }
  }, epi);
}

// out[r][n] = sum_{k < K} A[r][k] * W[k][n]: A times a weight read down
// its columns (row stride ldw), as in g W for a torch-layout W, with no
// transposed copy.  Any K (A zero-padded to a multiple of kKC).  Tile
// loads run along W's rows (coalesced in n).
template <typename T, typename Epi>
__device__ void gemm_rows_kn(const float* A, int lda, int K, const T* W,
                             int ldw, int N, float* wtile, Epi epi) {
  gemm_tiles(A, lda, K, N, wtile, [&](int n0, int k0) {
    for (int i = threadIdx.x; i < kNT * kKC; i += kThreads) {
      const int k = i / kNT, n = i % kNT;
      float v = 0.f;
      if (n0 + n < N && k0 + k < K)
        v = to_f(W[(size_t)(k0 + k) * ldw + n0 + n]);
      wtile[n * kWStride + k] = v;
    }
  }, epi);
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
