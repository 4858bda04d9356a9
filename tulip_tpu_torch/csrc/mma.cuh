// Tensor-core building blocks of the bf16 MLP kernels (mlp.cu, mlp_bwd.cu,
// reduce.cu) and of the bf16 attention half-block (window_msa.cu): Hopper's
// warpgroup product (wgmma) fed from a ring of shared-memory tiles that
// cp.async fills ahead of the product.
//
// One warpgroup (128 threads) owns a 64-row output tile; its fp32 sums stay
// in registers (N / 2 per thread for a 64 x N tile).  Both operands are read
// by the tensor cores straight from shared memory through 64-bit matrix
// descriptors, in the 128-byte-swizzled layout: a tile is rows of 64 bf16
// (128 bytes), the 16-byte chunk c of row r stored at chunk c ^ (r & 7), so
// that the 8 rows of a core matrix fall into 8 different bank groups.
// Both operand majors exist for bf16, so no product needs a transposed copy:
//   K-major  (trans 0): tile[row or column of the output][k], as x and a
//                       torch-layout weight in x W^T;
//   MN-major (trans 1): tile[k][row or column of the output], as W in g W
//                       and both operands of A^T B over tokens.
// Weights and streamed activations arrive through stream_tiles(): a ring of
// STAGES tiles, loads started STAGES - 2 tiles ahead with cp.async (16 bytes
// per thread and copy, zero-filled outside the matrix, so ragged edges need
// no second code path), one tile's products still in flight while the next
// tile's are started.  cp.async was taken over TMA: the tiles are small
// (8-24 KB), the edges are ragged (N, C = 96, O = 16), and every call brings
// other weights, so a tensor map would have to be encoded on the host per
// call and per operand; cp.async needs no cuTensorMapEncodeTiled and masks with
// its zero-fill size.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace tulip {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWg = 128;            // threads of one warpgroup = one CTA
constexpr int kBM = 64;             // output rows per CTA (wgmma's M)
constexpr uint32_t kSub = 8192;     // bytes of a 64 x 64 bf16 sub-tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c), c < 64, inside a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1)));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory writes (st.shared, completed cp.async)
// before later reads of the tensor cores, which use the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the copy of rows [r0, r0 + rows) x columns [c0, c0 + 64) of a
// row-major bf16 matrix (ld elements per row) into the swizzled tile at
// shared address dst; rows >= rmax and columns >= cmax arrive as zeros.
// c0, cmax and ld are multiples of 8 and src is 16-byte aligned.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, long long r0,
                                          long long rmax, int c0, int cmax,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += kWg) {
    const int r = i >> 3, ch = i & 7;
    const long long gr = r0 + r;
    const int gc = c0 + ch * 8;
    const bool ok = gr < rmax && gc < cmax;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4),
               ok ? src + gr * ld + gc : src, ok);
  }
}

// 64-bit shared-memory matrix descriptor, 128-byte swizzle: address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to the sums across an
// asynchronous product's start or wait.
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) = or += A (64 x 16) B (16 x N), both from shared memory;
// acc 0 overwrites d.  TA / TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
      "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int acc) {
  static_assert(N == 16 || N == 96 || N == 128 || N == 192, "tile width");
  if constexpr (N == 16) wgmma_n16<TA, TB>(d, a, b, acc);
  if constexpr (N == 96) wgmma_n96<TA, TB>(d, a, b, acc);
  if constexpr (N == 128) wgmma_n128<TA, TB>(d, a, b, acc);
  if constexpr (N == 192) wgmma_n192<TA, TB>(d, a, b, acc);
}

// Shared bytes of a B tile of N output columns and 64 reduction steps:
// K-major N rows of 128 bytes; MN-major one 64 x 64 sub-tile per 64 columns.
template <int N, int TB>
__host__ __device__ constexpr uint32_t b_tile_bytes() {
  return TB ? (uint32_t)((N + 63) / 64) * kSub : (uint32_t)N * 128;
}

// acc (+)= A B over one tile of up to 64 reduction steps (ksteps steps of
// 16), started asynchronously; first: the tile starts a new sum.
//   K-major operand: 8-row groups 1,024 bytes apart; a step of 16 along k
//   moves 32 bytes inside the swizzled row.
//   MN-major operand: 8-step groups 1,024 bytes apart, 64-column groups one
//   sub-tile apart; a step of 16 along k moves 16 rows = 2,048 bytes.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_tile(float (&acc)[N / 2], uint32_t a_addr,
                                         uint32_t b_addr, int ksteps,
                                         bool first) {
  const uint64_t da = make_desc(a_addr, TA ? kSub : 16, 1024);
  const uint64_t db = make_desc(b_addr, TB ? kSub : 16, 1024);
  constexpr uint64_t a_step = TA ? 2048 / 16 : 32 / 16;
  constexpr uint64_t b_step = TB ? 2048 / 16 : 32 / 16;
  fence_acc(acc);
  wgmma_fence();
  for (int k = 0; k < ksteps; ++k)
    wgmma<N, TA, TB>(acc, da + k * a_step, db + k * b_step,
                     (first && k == 0) ? 0 : 1);
  wgmma_commit();
  fence_acc(acc);
}

// Walk tiles 0 .. T - 1 through a ring of STAGES stages of stage_bytes at
// shared address ring.  fetch(t, addr) starts tile t's copies into the
// stage at addr (every thread calls it); use(t, addr) starts the tile's
// products with mma_tile() and then waits with wgmma_wait<1>() (or <0>
// before it reads the sums).  Copies run STAGES - 2 tiles ahead of the
// products, so a stage is refilled only after the products that read it
// have been waited for by every warp: tile t - 2's, before the barrier of
// step t.  The barrier also publishes what use() wrote to shared memory at
// earlier steps.
template <int STAGES, typename Fetch, typename Use>
__device__ __forceinline__ void stream_tiles(uint32_t ring,
                                             uint32_t stage_bytes, int T,
                                             Fetch fetch, Use use) {
  constexpr int kAhead = STAGES - 2;
  static_assert(kAhead >= 1, "the ring needs at least 3 stages");
  fence_async_proxy();   // operands the caller wrote to shared memory
  __syncthreads();       // and no warp still reads the ring
  for (int t = 0; t < kAhead; ++t) {
    if (t < T) fetch(t, ring + t * stage_bytes);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    cp_async_wait<kAhead - 1>();
    fence_async_proxy();
    __syncthreads();
    const int tn = t + kAhead;
    if (tn < T) fetch(tn, ring + (tn % STAGES) * stage_bytes);
    cp_async_commit();
    use(t, ring + (t % STAGES) * stage_bytes);
  }
}

// Row and column of sum element i of a 64 x N tile for this thread:
// element 4j + e sits in row 16 warp + lane / 4 + 8 (e / 2) and column
// 8j + 2 (lane % 4) + e % 2.  frag_row() is the row of e < 2, frag_col(j)
// the column of e = 0; e = 1 is the next column, e = 2, 3 eight rows below.
__device__ __forceinline__ int frag_row() {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col(int j) {
  return 8 * j + 2 * (threadIdx.x & 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory from the first 1,024-byte boundary on (the swizzle's
// period); the launch adds 1,024 bytes of room for it.
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// Copy a staged 64 x (64 tiles) bf16 block (swizzled tiles, kSub apart) to
// rows [r0, r0 + 64) x columns [c0, c0 + 64 tiles) of a row-major matrix
// with 16-byte stores, masked to rows < rmax and columns < cmax.
__device__ __forceinline__ void store_staged(const unsigned char* stage,
                                             bf16* dst, long long ld,
                                             long long r0, long long rmax,
                                             int c0, int cmax, int tiles) {
  for (int i = threadIdx.x; i < kBM * 8 * tiles; i += kWg) {
    const int r = i / (8 * tiles), ch = i % (8 * tiles);
    const int c = c0 + ch * 8;
    if (r0 + r >= rmax || c >= cmax) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        stage + (ch >> 3) * kSub + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(dst + (r0 + r) * ld + c) = v;
  }
}

// Eight bf16 of one 16-byte chunk as fp32, and back (rounded to nearest).
__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// One row's LayerNorm by one warp: yr = LN(xr) rounded to bf16; returns the
// row's mean and 1/std in every lane.  16-byte loads, fp32 statistics in
// two passes (mean, then the squared deviations) and a third that writes;
// the row comes from L1 after the first.  C % 8 == 0.
__device__ __forceinline__ float2 ln_one_row(const bf16* __restrict__ x,
                                             const bf16* __restrict__ lnw,
                                             const bf16* __restrict__ lnb,
                                             bf16* __restrict__ y, int C,
                                             float eps) {
  const int lane = threadIdx.x & 31;
  const uint4* xr = reinterpret_cast<const uint4*>(x);
  const uint4* wr = reinterpret_cast<const uint4*>(lnw);
  const uint4* br = reinterpret_cast<const uint4*>(lnb);
  uint4* yr = reinterpret_cast<uint4*>(y);
  const int chunks = C / 8;
  float v[8], w[8], b[8];
  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(xr[c], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i];
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    unpack8(xr[c], v);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane; c < chunks; c += 32) {
    unpack8(xr[c], v);
    unpack8(wr[c], w);
    unpack8(br[c], b);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (v[i] - mean) * rstd * w[i] + b[i];
    yr[c] = pack8(v);
  }
  return make_float2(mean, rstd);
}

// y = LN(x) rounded to bf16, and each row's mean and 1/std to stat[2r],
// stat[2r + 1] (stat may be null): the LayerNorm that the fused kernels
// apply in shared memory, as a pass of its own for the kernels that stream
// LN(x) as a product operand.  One warp per row (ln_one_row).  The pass has
// one body and a kernel name per caller, so that a profile tells K3 / K10's
// pass (ln_rows_kernel) from K4's and K11's (mlp.cu, mlp_bwd.cu).
constexpr int kLnRows = kThreads / 32;   // rows per CTA
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x,
                                        const bf16* __restrict__ lnw,
                                        const bf16* __restrict__ lnb,
                                        bf16* __restrict__ y,
                                        float* __restrict__ stat, int N,
                                        int C, float eps) {
  const long long r = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (r >= N) return;
  const float2 st = ln_one_row(x + r * C, lnw, lnb, y + r * C, C, eps);
  if (stat && (threadIdx.x & 31) == 0) {
    stat[2 * r] = st.x;
    stat[2 * r + 1] = st.y;
  }
}

static __global__ void __launch_bounds__(kThreads) ln_rows_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const bf16* __restrict__ lnb, bf16* __restrict__ y,
    float* __restrict__ stat, int N, int C, float eps) {
  ln_rows(x, lnw, lnb, y, stat, N, C, eps);
}

using LnRowsKernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*,
                              float*, int, int, float);

static inline cudaError_t launch_ln_rows(
    const bf16* x, const bf16* lnw, const bf16* lnb, bf16* y, float* stat,
    int N, int C, float eps, cudaStream_t stream,
    LnRowsKernel kernel = ln_rows_kernel) {
  kernel<<<(N + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(
      x, lnw, lnb, y, stat, N, C, eps);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace tulip
