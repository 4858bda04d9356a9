// Cross-block reductions of the backward kernels: column sums and the
// token-contracted weight-gradient product.
//
// The TPU backward kernels (tulip_tpu/ops/pallas/attn_core.py:_bwd_kernel,
// mlp.py:_bwd_kernel, mlp.py:_kernel_ln_mm_bwd) accumulate their weight and
// bias gradients across grid steps in one VMEM block, because the TPU grid
// runs in order.  CUDA blocks run in no order, so here every producer
// writes per-block partials and these kernels reduce them in a fixed order:
// the results are deterministic (no atomics).
//
// tulip_colsum: out[m] = sum_r in[r][m] over an (R, M) matrix, fp32 sums.
//   256-thread blocks of 32 columns x 8 row lanes; a first pass reduces
//   256 rows per block into a scratch (ceil(R / 256), M), a second pass
//   reduces those.  Bound: HBM reads of the input (one pass over it).
// tulip_tn_gemm: part[s][m][n] = sum_{t in split s} A[t][m] B[t][n] for
//   A (T, M), B (T, N) token-major (dW = dh^T y, g^T a, g^T y), split-K
//   over the token axis so that enough blocks run (stage 0 has 131,072
//   tokens against a 384 x 96 output); the splits are then summed by
//   tulip_colsum.
//   bf16: tn_gemm_tc_kernel, on the tensor cores (mma.cuh).  Bound: the
//   HBM reads of A and B (one pass; the output is small).  A 64 x BN output
//   tile per warpgroup (BN 192 where it divides N, else 128), the sums in
//   registers; both operands are token-major, which is the MN-major
//   operand layout of wgmma, so 64-token slices of A and B go through the
//   ring as they lie in memory: no transposed copy, three stages, the next
//   slice's copies overlapping this slice's products.
//   fp32: tn_gemm_tf32_kernel, split TF32 on the tensor cores (mma.cuh),
//   fp32's accuracy.  Bound: 2 T M N operations at 494.7 / 3 = 165
//   TFLOP/s against the HBM reads of A and B; at the training step's
//   shapes (M, N of 16 to 3,072 over up to 131,072 tokens) the reads bind
//   for the narrow outputs and the operations for the wide.  A 64 x 64
//   output tile per warpgroup, the sums in registers.  TF32 wgmma reads
//   K-major operands only, and both operands are token-major (MN-major for
//   the product), so each 32-token slice of A and of B lands raw through
//   mma.cuh's raw ring (three stages, cp.async two slices ahead): B is
//   transposed as it is split into hi / lo (split_mnmaj: no bank
//   conflict), A's fragments are read from the raw slice and split in
//   registers (frag_mnmaj); each slice's three TF32 products start from
//   zero and are folded into an fp32 total (one tensor-core chain over
//   all of a sum's tiles had 5-6x the error: PERF.md).  The token splits
//   (ops/reduce.py:tn_gemm_plan) are summed in split order by
//   tulip_colsum.  71 KB of shared memory: three blocks an SM.
#include "mma.cuh"

namespace tulip {

constexpr int kColBlockRows = 256;   // rows per block of the first pass

template <typename T>
__global__ void __launch_bounds__(kThreads) colsum_kernel(
    const T* __restrict__ in, float* __restrict__ out, long long R, int M,
    long long rows_per_block) {
  __shared__ float part[kThreads / 32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * 32 + tx;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(R, r0 + rows_per_block);
  float s = 0.f;
  if (m < M)
    for (long long r = r0 + ty; r < r1; r += kThreads / 32)
      s += to_f(in[r * M + m]);
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && m < M) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += part[i][tx];
    out[(long long)blockIdx.y * M + m] = t;
  }
}

template <typename T>
cudaError_t launch_colsum(const void* in, float* out, float* scratch,
                          long long R, int M, cudaStream_t stream) {
  if (R <= 0 || M <= 0) return cudaErrorInvalidValue;
  const unsigned gx = (unsigned)((M + 31) / 32);
  if (R <= 2 * kColBlockRows) {
    colsum_kernel<T><<<dim3(gx, 1), kThreads, 0, stream>>>(
        static_cast<const T*>(in), out, R, M, R);
    return cudaGetLastError();
  }
  const long long S = (R + kColBlockRows - 1) / kColBlockRows;
  if (!scratch || S > 65535) return cudaErrorInvalidValue;
  colsum_kernel<T><<<dim3(gx, (unsigned)S), kThreads, 0, stream>>>(
      static_cast<const T*>(in), scratch, R, M, kColBlockRows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<float><<<dim3(gx, 1), kThreads, 0, stream>>>(scratch, out, S,
                                                            M, S);
  return cudaGetLastError();
}

namespace tc {

constexpr int kTnStages = 3;

// grid (tiles of BN columns, tiles of 64 rows of the output, token splits);
// tps tokens per split, a multiple of 64.
template <int BN>
__global__ void __launch_bounds__(kWg) tn_gemm_tc_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    float* __restrict__ part, long long Tt, int M, int N, long long tps) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kB = b_tile_bytes<BN, 1>();
  constexpr uint32_t kStage = kB + kSub;
  const uint32_t ring = smem_u32(align_smem(smem_raw));

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const long long t0 = (long long)blockIdx.z * tps;
  const long long t1 = min(Tt, t0 + tps);
  const int T = (int)((t1 - t0 + 63) / 64);
  const int row = frag_row();

  float acc[BN / 2];
  auto fetch = [&](int t, uint32_t st) {
    const long long tt = t0 + (long long)t * 64;
#pragma unroll
    for (int s = 0; s < BN / 64; ++s)
      load_tile(st + s * kSub, B, N, tt, t1, n0 + 64 * s, N, 64);
    load_tile(st + kB, A, M, tt, t1, m0, M, 64);
  };
  auto use = [&](int t, uint32_t st) {
    const long long left = t1 - (t0 + (long long)t * 64);
    mma_tile<BN, 1, 1>(acc, st + kB, st, (int)min(4LL, (left + 15) / 16),
                       t == 0);
    if (t + 1 < T) {
      wgmma_wait<1>();
      return;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int n = n0 + frag_col(jj);
      if (n >= N) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + row + 8 * e;
        if (m < M)
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) =
              make_float2(acc[4 * jj + 2 * e], acc[4 * jj + 2 * e + 1]);
      }
    }
  };
  stream_tiles<kTnStages>(ring, kStage, T, fetch, use);
}

template <int BN>
cudaError_t launch_tn_gemm_tc(const bf16* A, const bf16* B, float* part,
                              long long Tt, int M, int N, long long tps,
                              cudaStream_t stream) {
  const long long S = (Tt + tps - 1) / tps;
  const int gy = (M + kBM - 1) / kBM;
  if (S > 65535 || gy > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      1024 + (size_t)kTnStages * (b_tile_bytes<BN, 1>() + kSub);
  cudaError_t err = prepare_smem(tn_gemm_tc_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  tn_gemm_tc_kernel<BN><<<dim3((N + BN - 1) / BN, gy, (unsigned)S), kWg,
                          smem, stream>>>(A, B, part, Tt, M, N, tps);
  return cudaGetLastError();
}

// fp32: grid (64-column tiles, 64-row tiles of the output, token splits);
// tps tokens per split, a multiple of 32.  Both operands are token-major,
// MN-major for the product, so each 32-token slice of A and of B lands raw
// (mma.cuh's raw ring): A's fragments are read from it and split in
// registers, B is split and transposed into K-major hi / lo tiles; each
// slice's split-TF32 products are folded into the fp32 total.
__global__ void __launch_bounds__(kWg, kF32Ctas) tn_gemm_tf32_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ part, long long Tt, int M, int N, long long tps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const uint32_t raw = smem_u32(sm);
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * kBM;
  const long long t0 = (long long)blockIdx.z * tps;
  const long long t1 = min(Tt, t0 + tps);
  const int T = (int)((t1 - t0 + 31) / 32);
  auto fetch = [&](int t, uint32_t st) {
    const long long tt = t0 + 32LL * t;
    load_mnmaj_f32(st, A, M, tt, t1, m0, M);
    load_mnmaj_f32(st + kF32Slot, B, N, tt, t1, n0, N);
  };
  auto split = [&](int, uint32_t st, uint32_t buf) {
    split_mnmaj(sm + (st - raw) + kF32Slot, sm + (buf - raw));
  };
  auto frag = [&](int, uint32_t st, uint32_t (&hi)[4][4],
                  uint32_t (&lo)[4][4]) {
    frag_mnmaj(sm + (st - raw), hi, lo);
  };
  raw_start(raw, T, fetch);
  float sum[32];
  fold_ring_tiles(sum, raw, T, 0, T, fetch, split, frag);
  store_frag64(sum, part + (size_t)blockIdx.z * M * N, N, m0, M, n0, N,
               [](int, float v) { return v; });
}

inline cudaError_t launch_tn_gemm_tf32(const float* A, const float* B,
                                       float* part, long long Tt, int M,
                                       int N, long long tps,
                                       cudaStream_t stream) {
  const long long S = (Tt + tps - 1) / tps;
  const int gy = (M + kBM - 1) / kBM;
  if (S > 65535 || gy > 65535) return cudaErrorInvalidValue;
  cudaError_t err = prepare_smem(tn_gemm_tf32_kernel, kF32RingSmem);
  if (err != cudaSuccess) return err;
  tn_gemm_tf32_kernel<<<dim3((N + 63) / 64, gy, (unsigned)S), kWg,
                        kF32RingSmem, stream>>>(A, B, part, Tt, M, N, tps);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// dtype of in (colsum) or of A and B (tn_gemm): 0 fp32, 1 bf16; the
// outputs and the scratch are fp32.  tn_gemm: M, N multiples of 8, tps a
// multiple of 32 (fp32) or of 64 (bf16).
extern "C" int tulip_colsum(int dtype, const void* in, void* out,
                            void* scratch, long long R, int M, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto sc = static_cast<float*>(scratch);
  if (dtype == 0) return tulip::launch_colsum<float>(in, o, sc, R, M, s);
  if (dtype == 1)
    return tulip::launch_colsum<__nv_bfloat16>(in, o, sc, R, M, s);
  return cudaErrorInvalidValue;
}

extern "C" int tulip_tn_gemm(int dtype, const void* A, const void* B,
                             void* part, long long Tt, int M, int N,
                             long long tps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  const int slice = dtype == 0 ? 32 : 64;
  if ((dtype != 0 && dtype != 1) || Tt <= 0 || M <= 0 || N <= 0 || M % 8 ||
      N % 8 || tps <= 0 || tps % slice)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return tulip::tc::launch_tn_gemm_tf32(static_cast<const float*>(A),
                                          static_cast<const float*>(B), p,
                                          Tt, M, N, tps, s);
  auto a = static_cast<const __nv_bfloat16*>(A);
  auto b = static_cast<const __nv_bfloat16*>(B);
  if (N % 192 == 0)
    return tulip::tc::launch_tn_gemm_tc<192>(a, b, p, Tt, M, N, tps, s);
  return tulip::tc::launch_tn_gemm_tc<128>(a, b, p, Tt, M, N, tps, s);
}
