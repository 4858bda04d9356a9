// Tensor-core building blocks of the bf16 MLP kernels (mlp.cu, mlp_bwd.cu,
// reduce.cu), of the bf16 attention half-block (window_msa.cu) and, at the
// end, of the fp32 ones (split TF32: window_msa.cu, mlp.cu, mlp_bwd.cu,
// reduce.cu): Hopper's
// warpgroup product (wgmma) fed from a ring of shared-memory tiles that
// cp.async fills ahead of the product.  At the end, the warp-level mma.sync
// products of one 16-token window and head, which the half-block and the
// training attention core (attn_core.cu) share.
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

// ---------------------------------------------------------------------------
// Warp-level products of one 16-token window and one head (head dim 32),
// shared by the attention half-block (window_msa.cu) and the training
// attention core (attn_core.cu): mma.sync m16n8k16, bf16 in, fp32 sums.
// Fragments (g = lane / 4, qd = lane % 4):
//   A (16 x 16): a[0] rows g, columns 2 qd + {0, 1}; a[1] rows g + 8; a[2],
//                a[3] the same eight columns on;
//   B (16 x 8):  b0 rows (k) 2 qd + {0, 1} of column (n) g; b1 rows + 8;
//   D (16 x 8):  d[e] row g + 8 (e / 2), column 2 qd + e % 2.
// The window's 16 x 16 logits are two D tiles, s[nt][e]: row g + 8 (e / 2),
// column 8 nt + 2 qd + e % 2.
// ---------------------------------------------------------------------------

// d (16 x 8, fp32) += A (16 x 16) B (16 x 8), bf16 fragments in registers.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Transpose of an 8 x 8 bf16 matrix held as an mma fragment (lane l: row
// l / 4, columns 2 (l % 4) + {0, 1}).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8 i .. 8 i + 7 give
// the row addresses of matrix i, whose fragment lands in d[i] (trans: the
// fragment of its transpose).  The "memory" clobber keeps them ordered with
// the warp's own stores to the same rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// A (16, 16) fp32 table (a head's bias, a window's shift mask) in the
// logits' fragment order: v[4 nt + 2 half + e] is row g + 8 half, column
// 8 nt + 2 qd + e.
__device__ __forceinline__ void load_frag16(const float* __restrict__ t,
                                            float (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 x = *reinterpret_cast<const float2*>(
          t + ((lane >> 2) + 8 * half) * 16 + 8 * nt + 2 * (lane & 3));
      v[4 * nt + 2 * half] = x.x;
      v[4 * nt + 2 * half + 1] = x.y;
    }
}

// s = softmax(s * scale + bias + mask) over each row, in place, fp32: the
// max subtracted per row, a row's max and sum over the 4 lanes that share
// it.  bias, mk: load_frag16 order (mk zeros without a mask).
__device__ __forceinline__ void window_softmax(float (&s)[2][4],
                                               const float (&bias)[8],
                                               const float (&mk)[8],
                                               float scale) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[nt][i] = s[nt][i] * scale + bias[4 * nt + i] + mk[4 * nt + i];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e = 2 * half;
    float m = fmaxf(fmaxf(s[0][e], s[0][e + 1]), fmaxf(s[1][e], s[1][e + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float e00 = expf(s[0][e] - m), e01 = expf(s[0][e + 1] - m);
    const float e10 = expf(s[1][e] - m), e11 = expf(s[1][e + 1] - m);
    float sum = (e00 + e01) + (e10 + e11);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    // one division a row: a masked entry's exp is denormal, and dividing
    // it takes the slow path
    const float inv = 1.f / sum;
    s[0][e] = e00 * inv;
    s[0][e + 1] = e01 * inv;
    s[1][e] = e10 * inv;
    s[1][e + 1] = e11 * inv;
  }
}

// A 16 x 16 matrix held as two D tiles, rounded to bf16 as the A operand of
// a product over its columns; and the A operand of its transpose.
__device__ __forceinline__ void pack_a(const float (&p)[2][4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[0][0], p[0][1]);
  a[1] = pack_bf16(p[0][2], p[0][3]);
  a[2] = pack_bf16(p[1][0], p[1][1]);
  a[3] = pack_bf16(p[1][2], p[1][3]);
}
__device__ __forceinline__ void transpose_a(const uint32_t (&a)[4],
                                            uint32_t (&t)[4]) {
  t[0] = movmatrix_trans(a[0]);
  t[1] = movmatrix_trans(a[2]);
  t[2] = movmatrix_trans(a[1]);
  t[3] = movmatrix_trans(a[3]);
}


// ---------------------------------------------------------------------------
// Split TF32 (3xTF32): the fp32 kernels' products on the tensor cores.
// An fp32 operand a is carried as hi = rna_tf32(a) and lo = rna_tf32(a -
// hi) (cvt.rna: round to nearest, ties away, to TF32's 10-bit mantissa);
// a product a b is hi_a hi_b + hi_a lo_b + lo_a hi_b, summed on the
// tensor cores with the two small terms first, each tile's sum then added
// to an fp32 total (mma3_tile, fold).  The dropped lo_a lo_b and the
// rounding of lo leave about 2^-21 of |a b|, against 2^-11 for one TF32
// pass (tests/test_torch_fp32_plans.py): about fp32's accuracy at three
// times TF32's cost (494.7 / 3 = 165 TFLOP/s dense on an H100 SXM).
//
// TF32 wgmma takes both shared-memory operands K-major only (no transpose
// bits).  A row of 32 fp32 is 128 bytes, so the bf16 tiles' 128-byte
// swizzle and descriptors carry over unchanged: a k-step of 8 TF32 moves
// 32 bytes inside the swizzled row, as a k-step of 16 bf16 does.  A tile
// of R rows x 32 fp32 holds hi where the copy landed and lo at a fixed
// offset behind it (split_rows).  The A operand may come from registers
// in the layout of mma.sync m16n8k8 per warp (a0 (g, q), a1 (g + 8, q),
// a2 (g, q + 4), a3 (g + 8, q + 4) for lane 4 g + q): a sum fragment of a
// 64 x N product holds columns 2q, 2q + 1 of each 8-column group, so it is
// that operand as it is when the reduction's 8 columns are taken in the
// order 0, 2, 4, 6, 1, 3, 5, 7 in both operands (split_rows(perm) stores
// the B tile so).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// Byte offset of fp32 element (r, c), c < 32, inside a swizzled tile.
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
}

// Start the copy of a tile of `rows` rows x 32 fp32 columns [c0, c0 + 32):
// tile row tr is matrix row row0 + (tr / 32) slab + tr % 32 of the
// row-major matrix src (ld elements a row); matrix rows >= rmax, and the
// whole tile where c0 >= cmax, arrive as zeros.  slab 32 walks consecutive
// rows.  c0, cmax and ld are multiples of 4 (cmax of 32), src 16-byte
// aligned.
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src,
                                              long long ld, long long row0,
                                              int slab, long long rmax,
                                              int c0, int cmax, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += kWg) {
    const int tr = i >> 3, ch = i & 7;
    const long long gr = row0 + (long long)(tr >> 5) * slab + (tr & 31);
    const bool ok = gr < rmax && c0 < cmax;
    cp_async16(dst + tr * 128 + ((ch ^ (tr & 7)) << 4),
               ok ? src + gr * ld + c0 + ch * 4 : src, ok);
  }
}

// Mean and 1/std (fp32, two passes over the row: the mean, then the
// squared deviations) of the CTA's 64 rows into stat[2 r], stat[2 r + 1];
// row(r) is the row's address, or null past the last token (stat 0, 0).
// One warp per row.
template <typename Row>
__device__ __forceinline__ void row_stats(Row row, int C, float eps,
                                          float* stat) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kBM; r += kWg / 32) {
    const float* p = row(r);
    float mean = 0.f, rstd = 0.f;
    if (p) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += p[c];
      mean = warp_sum(s) / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) q += (p[c] - mean) * (p[c] - mean);
      rstd = rsqrtf(warp_sum(q) / C + eps);
    }
    if (lane == 0) {
      stat[2 * r] = mean;
      stat[2 * r + 1] = rstd;
    }
  }
}

// Eight fp32 values of one row (columns 8 q .. 8 q + 7) split into hi at
// p and lo at p + lo_off, chunks o0 and o1 of the swizzled row; perm:
// stored as the even columns, then the odd ones (the B operand of a
// product whose A comes from a sum fragment).
__device__ __forceinline__ void split_store8(const float (&v)[8],
                                             unsigned char* p, uint32_t o0,
                                             uint32_t o1, uint32_t lo_off,
                                             bool perm) {
  uint32_t hi[8], lo[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // perm: stored position j holds column 2 j (j < 4) or 2 (j - 4) + 1
    const int src = perm ? (j < 4 ? 2 * j : 2 * (j - 4) + 1) : j;
    split_tf32(v[src], hi[j], lo[j]);
  }
  *reinterpret_cast<uint4*>(p + o0) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(p + o1) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  *reinterpret_cast<uint4*>(p + lo_off + o0) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(p + lo_off + o1) =
      make_uint4(lo[4], lo[5], lo[6], lo[7]);
}

// Split the `rows` landed rows of a swizzled fp32 tile at p: hi in place,
// lo at p + lo_off (the same layout).  Every thread takes two 16-byte
// chunks (8 columns) at a time.
__device__ __forceinline__ void split_rows(unsigned char* p, int rows,
                                           uint32_t lo_off, bool perm) {
  for (int i = threadIdx.x; i < rows * 4; i += kWg) {
    const int r = i >> 2, q = i & 3;
    const uint32_t o0 = r * 128 + (((2 * q) ^ (r & 7)) << 4);
    const uint32_t o1 = r * 128 + (((2 * q + 1) ^ (r & 7)) << 4);
    const float4 u = *reinterpret_cast<const float4*>(p + o0);
    const float4 w = *reinterpret_cast<const float4*>(p + o1);
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    split_store8(v, p, o0, o1, lo_off, perm);
  }
}

// The same for the 64 x rows of a tile, each value first taken through
// the LayerNorm, (v - mean) 1/std w[c] + b[c] for tile column c of matrix
// column c0 + c.  A thread takes rows thread / 4 and thread / 4 + 32;
// st[0], st[1] hold their (mean, 1/std) (row_stats; null rows (0, 0)).
__device__ __forceinline__ void split_rows_ln(unsigned char* p,
                                              uint32_t lo_off,
                                              const float2 (&st)[2],
                                              const float* __restrict__ lnw,
                                              const float* __restrict__ lnb,
                                              int c0) {
  const int q = threadIdx.x & 3;
  const float4* gw = reinterpret_cast<const float4*>(lnw + c0 + 8 * q);
  const float4* gb = reinterpret_cast<const float4*>(lnb + c0 + 8 * q);
  const float4 w0 = gw[0], w1 = gw[1], b0 = gb[0], b1 = gb[1];
  const float lw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const float lb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = (threadIdx.x >> 2) + 32 * m;
    const uint32_t o0 = r * 128 + (((2 * q) ^ (r & 7)) << 4);
    const uint32_t o1 = r * 128 + (((2 * q + 1) ^ (r & 7)) << 4);
    const float4 u = *reinterpret_cast<const float4*>(p + o0);
    const float4 w = *reinterpret_cast<const float4*>(p + o1);
    float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (v[j] - st[m].x) * st[m].y * lw[j] + lb[j];
    split_store8(v, p, o0, o1, lo_off, false);
  }
}

// This thread's two rows' (mean, 1/std) for split_rows_ln, from the
// statistics row_stats wrote to stat (after a barrier).
__device__ __forceinline__ void thread_stats(const float* stat,
                                             float2 (&st)[2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r = (threadIdx.x >> 2) + 32 * m;
    st[m] = make_float2(stat[2 * r], stat[2 * r + 1]);
  }
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_n96(float (&d)[48], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n96(float (&d)[48],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int acc) {
  static_assert(N == 64 || N == 96, "tile width");
  if constexpr (N == 64) wgmma_tf32_n64(d, a, b, acc);
  if constexpr (N == 96) wgmma_tf32_n96(d, a, b, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 96, "tile width");
  if constexpr (N == 16) wgmma_tf32_rs_n16(d, a, b, acc);
  if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, b, acc);
  if constexpr (N == 64) wgmma_tf32_rs_n64(d, a, b, acc);
  if constexpr (N == 96) wgmma_tf32_rs_n96(d, a, b, acc);
}

// acc (+)= A B^T over one 32-deep tile, split TF32, started
// asynchronously: A (64 x 32) and B (N x 32) K-major in shared memory, hi
// at a_hi / b_hi and lo at a_lo / b_lo.  Per k-step lo_a hi_b, hi_a lo_b,
// then hi_a hi_b.  fresh: the tile's sum starts from zero (set here, so
// the registers' old values are dead to the compiler), else it adds to
// acc.  The tensor cores' fp32 sums do not round to nearest, and a long
// chain of products into one accumulator drifts; so the callers start a
// fresh acc every tile or two and add it to their own fp32 total (fold),
// as fp32 code on the CUDA cores would sum.
template <int N>
__device__ __forceinline__ void mma3_tile(float (&acc)[N / 2], uint32_t a_hi,
                                          uint32_t a_lo, uint32_t b_hi,
                                          uint32_t b_lo, bool fresh) {
  const uint64_t ah = make_desc(a_hi, 16, 1024);
  const uint64_t al = make_desc(a_lo, 16, 1024);
  const uint64_t bh = make_desc(b_hi, 16, 1024);
  const uint64_t bl = make_desc(b_lo, 16, 1024);
  if (fresh) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_tf32<N>(acc, al + 2 * k, bh + 2 * k, 1);
    wgmma_tf32<N>(acc, ah + 2 * k, bl + 2 * k, 1);
    wgmma_tf32<N>(acc, ah + 2 * k, bh + 2 * k, 1);
  }
  wgmma_commit();
  fence_acc(acc);
}

// The same with A from registers: ahi[4 KK + k] / alo[4 KK + k] the A
// fragments of k-step k (in K3 columns in the order split_rows(perm)
// gives B; from frag_kmaj / frag_mnmaj in order).
template <int N, int KK, int R>
__device__ __forceinline__ void mma3_tile_rs(float (&acc)[N / 2],
                                             const uint32_t (&ahi)[R][4],
                                             const uint32_t (&alo)[R][4],
                                             uint32_t b_hi, uint32_t b_lo,
                                             bool fresh) {
  static_assert(4 * KK + 4 <= R, "k-steps");
  const uint64_t bh = make_desc(b_hi, 16, 1024);
  const uint64_t bl = make_desc(b_lo, 16, 1024);
  if (fresh) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_tf32_rs<N>(acc, alo[4 * KK + k], bh + 2 * k, 1);
    wgmma_tf32_rs<N>(acc, ahi[4 * KK + k], bl + 2 * k, 1);
    wgmma_tf32_rs<N>(acc, ahi[4 * KK + k], bh + 2 * k, 1);
  }
  wgmma_commit();
  fence_acc(acc);
}

// total += t in fp32 (round to nearest), after the products into t ended.
template <int R>
__device__ __forceinline__ void fold(float (&total)[R], float (&t)[R]) {
  fence_acc(t);
#pragma unroll
  for (int i = 0; i < R; ++i) total[i] += t[i];
}

// One tile of a sum over tiles, folded tile by tile: its products into
// cur (fresh), then the previous tile's in prev (the other of two
// accumulators that alternate) folded into total once they end; first:
// total starts at zero; last: this tile's are waited for and folded too.
template <int N>
__device__ __forceinline__ void mma3_fold(float (&total)[N / 2],
                                          float (&cur)[N / 2],
                                          float (&prev)[N / 2],
                                          uint32_t a_hi, uint32_t a_lo,
                                          uint32_t b_hi, uint32_t b_lo,
                                          bool first, bool last) {
  mma3_tile<N>(cur, a_hi, a_lo, b_hi, b_lo, true);
  if (first) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[i] = 0.f;
  } else {
    wgmma_wait<1>();
    fold(total, prev);
  }
  if (last) {
    wgmma_wait<0>();
    fold(total, cur);
  }
}

// stream_tiles for a split-TF32 kernel, in two parts for a kernel that
// walks its tiles in loops of its own: ring_start once, then split_tile(t)
// at each tile t in order, which waits for tile t's copies, starts those
// of tile t + STAGES - 2, has split(t, st) take its landed rows to hi and
// lo in place (every thread), and returns its stage.  Registers that one kind of tile
// needs are then dead across the others, where one use() that branches on
// the kind keeps them all live.
template <int STAGES, typename Fetch>
__device__ __forceinline__ void ring_start(uint32_t ring,
                                           uint32_t stage_bytes, int T,
                                           Fetch fetch) {
  constexpr int kAhead = STAGES - 2;
  static_assert(kAhead >= 1, "the ring needs at least 3 stages");
  fence_async_proxy();
  __syncthreads();
  for (int t = 0; t < kAhead; ++t) {
    if (t < T) fetch(t, ring + t * stage_bytes);
    cp_async_commit();
  }
}
template <int STAGES, typename Fetch, typename Split>
__device__ __forceinline__ uint32_t split_tile(uint32_t ring,
                                               uint32_t stage_bytes, int T,
                                               int t, Fetch fetch,
                                               Split split) {
  constexpr int kAhead = STAGES - 2;
  cp_async_wait<kAhead - 1>();
  fence_async_proxy();
  __syncthreads();
  const int tn = t + kAhead;
  if (tn < T) fetch(tn, ring + (tn % STAGES) * stage_bytes);
  cp_async_commit();
  const uint32_t st = ring + (t % STAGES) * stage_bytes;
  split(t, st);
  fence_async_proxy();
  __syncthreads();
  return st;
}

// Both parts for a kernel of one kind of tile: use(t, st) starts tile t's
// products after its split.
template <int STAGES, typename Fetch, typename Split, typename Use>
__device__ __forceinline__ void stream_split_tiles(uint32_t ring,
                                                   uint32_t stage_bytes,
                                                   int T, Fetch fetch,
                                                   Split split, Use use) {
  ring_start<STAGES>(ring, stage_bytes, T, fetch);
  for (int t = 0; t < T; ++t)
    use(t, split_tile<STAGES>(ring, stage_bytes, T, t, fetch, split));
}

// A row's mean and 1/std in fp32, by one warp: lane l sums the row's
// 16-byte chunks l, l + 32, ... (each (x + y) + (z + w)), the warp adds
// the lanes' sums; then the squared deviations alike, reading the row
// again (from L1).  The order depends on K alone.  K % 4 == 0, p 16-byte
// aligned.  K4's statistics pass (mlp.cu) and the fp32 backward's LN pass
// (mlp_bwd.cu).
__device__ __forceinline__ float2 row_mean_rstd(const float* __restrict__ p,
                                                int K, float eps) {
  const int lane = threadIdx.x & 31;
  const float4* q = reinterpret_cast<const float4*>(p);
  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = q[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / K;
  float d = 0.f;
#pragma unroll 4
  for (int c = lane; c < K / 4; c += 32) {
    const float4 v = q[c];
    const float e0 = v.x - mean, e1 = v.y - mean, e2 = v.z - mean,
                e3 = v.w - mean;
    d += (e0 * e0 + e1 * e1) + (e2 * e2 + e3 * e3);
  }
  return make_float2(mean, rsqrtf(warp_sum(d) / K + eps));
}

// ---------------------------------------------------------------------------
// Split TF32 from a raw ring, A from registers: the fp32 backward
// (mlp_bwd.cu) and the fp32 weight-gradient product (reduce.cu), whose
// operands lie in memory K-major (x, dh, g as A: a token row's values
// along the reduction) or MN-major (W2 in g W2, W1 in dh W1, W in g W, and
// both token-major operands of A^T B over tokens).  TF32 wgmma reads
// shared-memory operands K-major only.  So every tile lands raw, as it
// lies in memory, through a ring of kF32RawStages stages (cp.async
// kF32RawStages - 1 tiles ahead), and then:
//   - B (the 64 output columns' operand) is split by every thread into hi
//     and lo, K-major and swizzled, in the split buffer (raw_split_tile);
//     an MN-major B is transposed as it is split;
//   - A (the 64 output rows' operand) never reaches the split buffer: each
//     thread reads its own elements of the landed tile in the A-fragment
//     layout of wgmma's register operand and splits them in registers
//     (frag_kmaj, frag_mnmaj), so the products read only B from shared
//     memory (wgmma ... m64n64k8 with A in registers): a 64 x 64 x 32
//     tile's three products read 24 KB of it instead of 48, and the split
//     writes 16 KB instead of 32.
// Each tile's products are waited for before the next tile (fold_ring_
// tiles), so one split buffer does, and the registers of one accumulator
// and one set of A fragments: 1 KB of alignment room + 16 KB + three raw
// stages of two 9,216-byte slots = 71 KB and at most 168 registers, three
// blocks an SM, whose splits and waits interleave.  Measured slower
// (PERF.md): two blocks with four raw stages, and a ring that splits tile
// t + 1 while tile t's products run (two raw stages, two split buffers).
//   K-major raw tile (64 rows x 32): row r chunk c at r * 128 + ((c ^ (r
//     & 7)) << 4), the split tile's layout, so split_kmaj splits chunk i
//     into chunk i of hi and of lo; frag_kmaj's lanes read eight rows' 16
//     bytes in different bank groups (no conflict).
//   MN-major raw tile (32 x 64, the reduction along its rows): row-major
//     with kMnLd = 72 floats a row.  split_mnmaj's item (r, q) reads raw
//     rows 4 q .. 4 q + 3 at column r and writes chunk q of split row r: a
//     warp reads 32 consecutive floats of one row and writes 16-byte
//     chunks of rows r .. r + 7 that the swizzle puts into eight bank
//     groups; frag_mnmaj's lanes (g, q) read row 8 ks + q, column 16 warp +
//     g, banks 8 q + g: no conflict either way.
// ---------------------------------------------------------------------------

constexpr int kF32Ctas = 3;                      // blocks an SM
constexpr int kF32RawStages = 3;
constexpr int kMnLd = 72;                        // floats a raw MN-major row
constexpr uint32_t kF32Slot = 32 * kMnLd * 4;    // one operand's raw tile
constexpr uint32_t kF32Raw = 2 * kF32Slot;       // a raw stage: A, then B
constexpr uint32_t kF32Tile = 64 * 128;          // a 64 x 32 split tile
constexpr uint32_t kF32Split = 2 * kF32Tile;     // the split buffer: hi, lo
constexpr uint32_t kF32RingSmem =
    1024 + kF32Split + kF32RawStages * kF32Raw;

// Start the copy of rows [r0, r0 + 64) x columns [c0, c0 + 32) of a
// row-major fp32 matrix (ld elements a row) into a K-major raw tile;
// rows >= rmax and 16-byte chunks from column cmax on arrive as zeros.
// c0, cmax and ld multiples of 4, src 16-byte aligned.
__device__ __forceinline__ void load_kmaj_f32(uint32_t dst, const float* src,
                                              long long ld, long long r0,
                                              long long rmax, int c0,
                                              int cmax) {
  for (int i = threadIdx.x; i < 64 * 8; i += kWg) {
    const int r = i >> 3, ch = i & 7;
    const long long gr = r0 + r;
    const int gc = c0 + 4 * ch;
    const bool ok = gr < rmax && gc < cmax;
    cp_async16(dst + r * 128 + ((ch ^ (r & 7)) << 4),
               ok ? src + gr * ld + gc : src, ok);
  }
}

// Start the copy of rows [k0, k0 + 32) x columns [c0, c0 + 64) of a
// row-major fp32 matrix into an MN-major raw tile; rows >= kmax and chunks
// from column cmax on arrive as zeros.  As load_kmaj_f32's alignment.
__device__ __forceinline__ void load_mnmaj_f32(uint32_t dst, const float* src,
                                               long long ld, long long k0,
                                               long long kmax, int c0,
                                               int cmax) {
  for (int i = threadIdx.x; i < 32 * 16; i += kWg) {
    const int k = i >> 4, ch = i & 15;
    const long long gk = k0 + k;
    const int gc = c0 + 4 * ch;
    const bool ok = gk < kmax && gc < cmax;
    cp_async16(dst + (k * kMnLd + 4 * ch) * 4,
               ok ? src + gk * ld + gc : src, ok);
  }
}

__device__ __forceinline__ void split4(const float4& v, uint4& hi, uint4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

// A landed K-major raw tile split into hi at dst and lo at dst + kF32Tile
// (the same swizzled layout).
__device__ __forceinline__ void split_kmaj(const unsigned char* raw,
                                           unsigned char* dst) {
  for (int i = threadIdx.x; i < 64 * 8; i += kWg) {
    uint4 hi, lo;
    split4(reinterpret_cast<const float4*>(raw)[i], hi, lo);
    reinterpret_cast<uint4*>(dst)[i] = hi;
    reinterpret_cast<uint4*>(dst + kF32Tile)[i] = lo;
  }
}

// A landed MN-major raw tile (32 x 64) split and transposed into a K-major
// tile of 64 rows x 32: hi at dst, lo at dst + kF32Tile.
__device__ __forceinline__ void split_mnmaj(const unsigned char* raw,
                                            unsigned char* dst) {
  const float* s = reinterpret_cast<const float*>(raw);
  for (int i = threadIdx.x; i < 64 * 8; i += kWg) {
    const int r = i & 63, q = i >> 6;
    const float4 v =
        make_float4(s[(4 * q) * kMnLd + r], s[(4 * q + 1) * kMnLd + r],
                    s[(4 * q + 2) * kMnLd + r], s[(4 * q + 3) * kMnLd + r]);
    uint4 hi, lo;
    split4(v, hi, lo);
    const uint32_t o = r * 128 + ((q ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(dst + o) = hi;
    *reinterpret_cast<uint4*>(dst + kF32Tile + o) = lo;
  }
}

// This thread's A fragments (k-step ks, register i: row 16 warp + g + 8 (i
// & 1), column 8 ks + q + 4 (i >> 1) for lane 4 g + q) of a landed raw
// tile, split: from a K-major tile (element (r, c) at swz32(r, c)) or an
// MN-major one (at raw[c * kMnLd + r]).
__device__ __forceinline__ void frag_kmaj(const unsigned char* raw,
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
  const int r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = *reinterpret_cast<const float*>(
          raw + swz32(r0 + 8 * (i & 1), 8 * ks + q + 4 * (i >> 1)));
      split_tf32(v, hi[ks][i], lo[ks][i]);
    }
}
__device__ __forceinline__ void frag_mnmaj(const unsigned char* raw,
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
  const float* s = reinterpret_cast<const float*>(raw);
  const int r0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(s[(8 * ks + q + 4 * (i >> 1)) * kMnLd + r0 + 8 * (i & 1)],
                 hi[ks][i], lo[ks][i]);
}

// The raw ring in two parts, as ring_start / split_tile: raw_start once,
// then raw_split_tile(t) at each tile t in order.  It waits for tile t's
// copies, starts those of tile t + kF32RawStages - 1 into the stage that
// tile t - 1 left (read before the last barrier), and has split(t, raw
// stage, split buffer) write tile t's B as hi and lo (every thread) into
// the split buffer, which sits at raw.  The products of tile t - 1 read
// it: the caller waits for them before it calls for tile t.
// raw_stage(raw, t) is tile t's stage.
__device__ __forceinline__ uint32_t raw_stage(uint32_t raw, int t) {
  return raw + kF32Split + (t % kF32RawStages) * kF32Raw;
}
template <typename Fetch>
__device__ __forceinline__ void raw_start(uint32_t raw, int T, Fetch fetch) {
  __syncthreads();   // no warp still reads the ring or the split buffer
  for (int t = 0; t < kF32RawStages - 1; ++t) {
    if (t < T) fetch(t, raw_stage(raw, t));
    cp_async_commit();
  }
}
template <typename Fetch, typename Split>
__device__ __forceinline__ void raw_split_tile(uint32_t raw, int T, int t,
                                               Fetch fetch, Split split) {
  cp_async_wait<kF32RawStages - 2>();
  __syncthreads();
  const int tn = t + kF32RawStages - 1;
  if (tn < T) fetch(tn, raw_stage(raw, tn));
  cp_async_commit();
  split(t, raw_stage(raw, t), raw);
  fence_async_proxy();
  __syncthreads();
}

// Keeps registers that an asynchronous product reads allocated and
// unchanged until the caller has waited for it.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// total (64 x 64) = the sum over ring tiles t0 .. t0 + n - 1 of A_t B_t^T:
// A_t's fragments from frag(t, raw stage, hi, lo), B_t from the split
// buffer; each tile's products start from zero, are waited for and are
// added to the fp32 total (fold).  T: the ring's tile count.  A tile's
// products are not left in flight across the next tile's split, as
// mma3_fold leaves them: in such a loop ptxas puts a full warpgroup wait
// (WARPGROUP.DEPBAR.LE gsb0, 0x0) before the loop's back edge (C7517), so
// two accumulators that alternate overlap nothing and cost the registers
// that a third block an SM needs; the other blocks fill the wait.
template <typename Fetch, typename Split, typename Frag>
__device__ __forceinline__ void fold_ring_tiles(float (&total)[32],
                                                uint32_t raw, int T, int t0,
                                                int n, Fetch fetch,
                                                Split split, Frag frag) {
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int t = t0 + j;
    raw_split_tile(raw, T, t, fetch, split);
    uint32_t hi[4][4], lo[4][4];
    float acc[32];
    frag(t, raw_stage(raw, t), hi, lo);
    mma3_tile_rs<64, 0>(acc, hi, lo, raw, raw + kF32Tile, true);
    wgmma_wait<0>();
    fence_regs(hi);
    fence_regs(lo);
    fold(total, acc);
  }
}

// Store a 64 x 64 fp32 sum tile (this thread's fragment) as float2 pairs
// to out (row-major, ld a row) at rows r0 + .., columns c0 + .., masked to
// rows < rmax and columns < cmax (cmax even); v(i, value) may change
// fragment element i (frag_row / frag_col's order) before it is stored.
template <typename F>
__device__ __forceinline__ void store_frag64(const float (&s)[32], float* out,
                                             long long ld, long long r0,
                                             long long rmax, int c0, int cmax,
                                             F v) {
  const int row = frag_row();
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = c0 + frag_col(jj);
    if (c >= cmax) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long r = r0 + row + 8 * e;
      if (r < rmax)
        *reinterpret_cast<float2*>(out + r * ld + c) =
            make_float2(v(4 * jj + 2 * e, s[4 * jj + 2 * e]),
                        v(4 * jj + 2 * e + 1, s[4 * jj + 2 * e + 1]));
    }
  }
}

// d (16 x 8, fp32) += A (16 x 8) B (8 x 8), TF32 fragments in registers
// (mma.sync m16n8k8: a as above, b0 row q column g, b1 row q + 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in split TF32 from fp32 operands in registers: a[] in the A
// fragment order, b0 / b1 as above.
__device__ __forceinline__ void mma3_sync(float (&d)[4], const float (&a)[4],
                                          float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace tc
}  // namespace tulip
