// Exact nearest-neighbour squared distances for the chamfer metric.
//
// tulip_nn_brute replaces tulip_tpu/ops/pallas/chamfer.py:_kernel (K7):
//   out[i] = min_j |a_i - b_j|^2 over every target point.
// tulip_nn_h replaces tulip_tpu/ops/pallas/chamfer_h.py:_kernel_h (K6): the
//   same minimum over Morton-sorted clouds, visiting target chunks in
//   ascending lower-bound order and stopping at the first chunk whose bound
//   cannot beat the tile's worst current minimum.
// tulip_nn_h2 replaces chamfer_h.py:_kernel_h2 (K5): both directions from
//   one distance tile; row mins give d(a->b), column mins give d(b->a).
//
// Numerics: the direct form dx*dx + dy*dy + dz*dz in fp32 (sq_dist below).
// It cannot go negative and does not cancel, unlike the TPU's augmented
// |b|^2 - 2a.b + |a|^2 contraction, which loses ~1e-3 m^2 per pair at 120 m.
// All three kernels use the same sq_dist, so K5 and K6 return K7's values.
//
// Bound on the H100: compute.  Brute force at 262,144 x 262,144 points is
// 6.9e10 pairs of 7 fp32 instructions (3 sub, mul, 2 fma, min), ~14 ms of
// the card's fp32 issue rate; the inputs are 3 MB each and stay in L2.
// Design: one block of 128 threads per 512-query tile (each thread keeps 4
// queries and their running minima in registers: 512 blocks at 262k points,
// ~3.9 per SM); the block stages one target chunk at a time in shared memory
// as three coordinate arrays that every thread reads by broadcast.  K5/K6
// add the TPU kernels' exact tile skipping over the pairs of two scans of
// one scene.  Tensor cores are not used: the fp32 minimum of a 3-term sum
// is CUDA-core work.  Measured on an H100 80GB HBM3 at 700 W, a synthetic
// DurLAR scan against a perturbed copy (262,144 points each): K7 20.9 ms
// per direction, K6 14.4 ms per direction, K5 9.2 ms for both directions.
//
// Ragged query counts are masked in the kernel: a query row >= N sits at
// +inf (its distances are +inf and never win a column minimum) and its row
// minimum starts at 0 (so it never holds the tile's worst minimum up).
#include <cuda_runtime.h>

#include "common.cuh"

namespace tulip {
namespace nn {

constexpr int kThreads = 128;
constexpr int kQ = 4;                    // queries per thread
constexpr int kTile = kThreads * kQ;     // query rows per block
constexpr int kWarps = kThreads / 32;
constexpr float kInit = 1e30f;           // "no minimum yet", as on the TPU

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

struct Queries {
  float x[kQ], y[kQ], z[kQ], best[kQ];
};

// Query q of this thread is row blockIdx.x * kTile + q * kThreads + tid.
__device__ __forceinline__ Queries load_queries(const float* a, int N) {
  Queries s;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long r = (long long)blockIdx.x * kTile + q * kThreads +
                        threadIdx.x;
    if (r < N) {
      s.x[q] = a[3 * r];
      s.y[q] = a[3 * r + 1];
      s.z[q] = a[3 * r + 2];
      s.best[q] = kInit;
    } else {
      s.x[q] = s.y[q] = s.z[q] = __int_as_float(0x7f800000);  // +inf
      s.best[q] = 0.f;
    }
  }
  return s;
}

__device__ __forceinline__ void store_best(const Queries& s, float* out,
                                           int N) {
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long r = (long long)blockIdx.x * kTile + q * kThreads +
                        threadIdx.x;
    if (r < N) out[r] = s.best[q];
  }
}

// Stage target points [c0, c0 + TM) of b (M x 3) as sb[0..TM) = x,
// sb[TM..2TM) = y, sb[2TM..3TM) = z.  The caller synchronises.
__device__ __forceinline__ void stage_chunk(const float* b, long long c0,
                                            int TM, float* sb) {
  const float* src = b + 3 * c0;
  for (int i = threadIdx.x; i < 3 * TM; i += kThreads)
    sb[(i % 3) * TM + i / 3] = src[i];
}

// Every thread's queries against the staged chunk (broadcast reads).
__device__ __forceinline__ void sweep_rows(Queries& s, const float* sb,
                                           int TM) {
  const float* bx = sb;
  const float* by = sb + TM;
  const float* bz = sb + 2 * TM;
#pragma unroll 4
  for (int j = 0; j < TM; ++j) {
    const float x = bx[j], y = by[j], z = bz[j];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      s.best[q] = fminf(s.best[q], sq_dist(s.x[q], s.y[q], s.z[q], x, y, z));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of v (every thread gets it).  Starts with a barrier, so the
// previous step's readers of sb and red are done when it returns.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float worst(const Queries& s) {
  float m = s.best[0];
#pragma unroll
  for (int q = 1; q < kQ; ++q) m = fmaxf(m, s.best[q]);
  return m;
}

// K7: every query tile against every target chunk.
__global__ void __launch_bounds__(kThreads) brute_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int N, int M, int TM) {
  extern __shared__ float sb[];
  Queries s = load_queries(a, N);
  for (long long c0 = 0; c0 < M; c0 += TM) {
    __syncthreads();
    stage_chunk(b, c0, TM, sb);
    __syncthreads();
    sweep_rows(s, sb, TM);
  }
  store_best(s, out, N);
}

// K6: a_s, b_s Morton-sorted; row i of order / lb_sorted (Ni x Nj) lists
// this tile's target chunks by ascending squared lower bound.  cur, the
// tile's worst current minimum, only falls and the bounds only rise, so the
// first chunk with lb >= cur ends the walk exactly: no later chunk holds a
// point nearer than any query's current minimum (the bounds carry 1e-3 m of
// slack for the fp32 rounding of both the bound and the distances).  On the
// TPU every later grid step still paid a scalar test.
__global__ void __launch_bounds__(kThreads) h_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ lb_sorted, const int* __restrict__ order,
    float* __restrict__ out, int N, int Nj, int TM) {
  extern __shared__ float sb[];
  __shared__ float red[kWarps];
  Queries s = load_queries(a, N);
  const long long row = (long long)blockIdx.x * Nj;
  for (int k = 0; k < Nj; ++k) {
    const float cur = block_max(worst(s), red);
    if (k > 0 && lb_sorted[row + k] >= cur) break;   // uniform in the block
    stage_chunk(b, (long long)order[row + k] * TM, TM, sb);
    __syncthreads();
    sweep_rows(s, sb, TM);
  }
  store_best(s, out, N);
}

// K5: as K6, but the distance tile also yields the chunk's column minima.
// On the TPU they accumulated in one VMEM table that the grid updated in
// order.  Here every block that visits chunk idx reduces its column minima
// in shared memory and then lowers out_b (filled with 1e30 by the caller)
// with an integer atomicMin on the float's bits, which orders non-negative
// floats as their values (the direct form is never negative).
//
// A chunk is skipped when lb >= cur_a and lb >= cur_b, cur_b being the
// largest out_b entry of the chunk as read now.  Other blocks lower out_b
// while it is read, but every value read was held by the entry, so it is
// never below the entry's final minimum f_j.  Skipping is then exact: every
// distance in the tile pair is >= lb >= read value >= f_j, so the pair could
// not lower any column's minimum, and the a-direction argument is K6's.
// The walk cannot stop early: cur_b belongs to the chunk, not to the tile.
//
// Columns are visited in a lane-rotated order (j = j0 + (lane + r) % 32), so
// the 32 lanes of a warp read and atomically lower 32 different entries of
// the shared column-min table at each step, without bank conflicts.
__global__ void __launch_bounds__(kThreads) h2_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ lb_sorted, const int* __restrict__ order,
    float* __restrict__ out_a, float* out_b, int N, int Nj, int TM) {
  extern __shared__ float smem[];
  float* sb = smem;                      // [3][TM] staged chunk
  float* colmin = smem + 3 * TM;         // [TM] the block's column minima
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31;
  Queries s = load_queries(a, N);
  const long long row = (long long)blockIdx.x * Nj;
  for (int k = 0; k < Nj; ++k) {
    const long long c0 = (long long)order[row + k] * TM;
    const float lb = lb_sorted[row + k];
    float vb = 0.f;
    for (int j = threadIdx.x; j < TM; j += kThreads)
      vb = fmaxf(vb, __ldcg(out_b + c0 + j));
    const float cur_b = block_max(vb, red);
    const float cur_a = block_max(worst(s), red);
    if (!(lb < cur_a || lb < cur_b)) continue;       // uniform in the block
    stage_chunk(b, c0, TM, sb);
    for (int j = threadIdx.x; j < TM; j += kThreads) colmin[j] = kInit;
    __syncthreads();
    const float* bx = sb;
    const float* by = sb + TM;
    const float* bz = sb + 2 * TM;
    for (int j0 = 0; j0 < TM; j0 += 32) {
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const int j = j0 + ((lane + r) & 31);
        const float x = bx[j], y = by[j], z = bz[j];
        float m = __int_as_float(0x7f800000);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float d = sq_dist(s.x[q], s.y[q], s.z[q], x, y, z);
          s.best[q] = fminf(s.best[q], d);
          m = fminf(m, d);
        }
        atomicMin(reinterpret_cast<int*>(colmin + j), __float_as_int(m));
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < TM; j += kThreads) {
      const float m = colmin[j];
      float* dst = out_b + c0 + j;
      if (m < __ldcg(dst))
        atomicMin(reinterpret_cast<int*>(dst), __float_as_int(m));
    }
  }
  store_best(s, out_a, N);
}

// Shared launch checks: N, M > 0, TM a positive multiple of 32 dividing M,
// and the staged chunk within the block's shared memory.
inline bool shapes_ok(int N, int M, int TM) {
  return N > 0 && M > 0 && TM > 0 && TM % 32 == 0 && M % TM == 0;
}

}  // namespace nn
}  // namespace tulip

extern "C" int tulip_nn_brute(const void* a, const void* b, void* out, int N,
                              int M, int chunk, void* stream) {
  using namespace tulip::nn;
  if (!shapes_ok(N, M, chunk)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * chunk;
  cudaError_t err = tulip::prepare_smem(brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kTile - 1) / kTile;
  brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), N, M, chunk);
  return cudaGetLastError();
}

// lb_sorted (fp32) and order (int32) are (ceil(N / tile), M / chunk); tile
// must be the kernels' query tile (kTile).
extern "C" int tulip_nn_h(const void* a, const void* b, const void* lb_sorted,
                          const void* order, void* out, int N, int M,
                          int chunk, int tile, void* stream) {
  using namespace tulip::nn;
  if (!shapes_ok(N, M, chunk) || tile != kTile) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * chunk;
  cudaError_t err = tulip::prepare_smem(h_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kTile - 1) / kTile;
  h_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(lb_sorted), static_cast<const int*>(order),
      static_cast<float*>(out), N, M / chunk, chunk);
  return cudaGetLastError();
}

// out_b (M,) must hold 1e30 (or any upper bound) on entry.
extern "C" int tulip_nn_h2(const void* a, const void* b, const void* lb_sorted,
                           const void* order, void* out_a, void* out_b, int N,
                           int M, int chunk, int tile, void* stream) {
  using namespace tulip::nn;
  if (!shapes_ok(N, M, chunk) || tile != kTile) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * chunk;
  cudaError_t err = tulip::prepare_smem(h2_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kTile - 1) / kTile;
  h2_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(lb_sorted), static_cast<const int*>(order),
      static_cast<float*>(out_a), static_cast<float*>(out_b), N, M / chunk,
      chunk);
  return cudaGetLastError();
}
