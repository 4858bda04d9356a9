// Fused shifted-window MSA half-block: out = x + proj(MSA(LN1(x))).
//
// Replaces: tulip_tpu/ops/pallas/window_msa.py:_kernel_masked_nat (heads
// <= 8) and window_msa.py:_kernel (heads > 8), and their layout twins
// window_msa.py:_kernel_masked (heads <= 8 on the grouped window-major
// layout) and window_msa.py:_kernel_nat (heads > 8 on natural row strips).
// One row map serves all four: the TPU kernels differ only in layout and
// head count.  Natural row strips (R, wh, W, C) are NHWC memory as it is,
// so that entry is tulip_window_msa with shift (0, 0), the caller rolling.
// On the grouped layout a window's 16 tokens are 16 consecutive rows of
// the token matrix: tulip_window_msa_grouped hands the kernel that
// addressing as the geometry H = nW windows, W = 16, window (1, 16), no
// shift, so that token t of window n sits at row n * 16 + t and the
// window's mask is mask[n % nW].  The TPU kernels' block-diagonal
// (nh, 128, 128) bias and -1e9 group mask are a layout device and are not
// taken: bias and mask stay (nh, 16, 16) and (nW, 16, 16).
//
// Computes, per 2x8 window of 16 tokens, with q, k, v = LN1(x) Wqkv^T + b:
//   out = x + proj( concat_h softmax(q_h k_h^T * hd^-1/2 + B_h [+ M_win]) v_h )
// B_h: gathered relative-position bias (nh, 16, 16) fp32; M_win: the 0/-100
// shift mask of the window, (nW, 16, 16) fp32.  A shifted block's token t of
// window (i, j) reads and writes x[(i*wh + t/ww + sh) % H][(j*ww + t%ww + sw)
// % W]: roll(-s) -> attention -> roll(+s) as addressing, no copies.
// LN statistics, logits, softmax (max-subtracted) and all accumulation are
// fp32; the LN output, q/k/v, probabilities and head outputs are rounded to
// the activation dtype.
//
// Bound on the H100: T (8 C^2 + 64 C) operations against 4 T C bytes of
// activations and 8 C^2 of weights, 2 C + 16 operations a byte where the
// tokens outweigh the weights: at the model's token counts stage 0 (C = 96)
// is bound by its bytes, C >= 192 by its operations (C = 768 at batch 1 by
// its weights' bytes).  Either way the qkv and proj products are 92-99 % of
// the work, and a weight element must serve many rows once it has come.
//
// bf16: window_msa_tc_kernel, on the tensor cores (mma.cuh).  One warpgroup
// per 64 token rows = 4 whole windows (tile row 16 w + t is token t of the
// CTA's window w; the rows' addresses come from a 64-entry offset table)
// and per slice of the heads; grid (row tiles, head splits).
//   1. y = LN1(x): the rows are gathered with 16-byte cp.async copies, all
//      in flight at once, into the swizzled operand layout; then one warp
//      per row normalises it in registers and rounds it once, in place
//      (for C <= 1,024; wider rows are normalised by a pass of their own
//      into a window-major scratch and streamed beside the weights).
//   2. Per head: q | k | v = y Wqkv[head's three 32-row slabs]^T as one
//      64 x 96 wgmma tile summed over 64-deep weight tiles from the ring.
//      wgmma gives warp w rows 16 w .. 16 w + 15 of that tile: its own
//      window's q, k and v.  That fragment is mma.sync's operand layout, so
//      after + bias and rounding the 16 x 16 logits are 4 mma.sync
//      (m16n8k16) straight from registers; scale, + bias, + mask, the exact
//      max-subtracted softmax over the 4 lanes that share a row (mma.cuh:
//      window_softmax, which the training attention core of attn_core.cu
//      shares); P packed as
//      the A operand of P V; v transposed in registers (movmatrix) into the
//      B operand; 4 more mma.sync.  The head's 16 x 32 output is rounded
//      into the swizzled ao tile.  No barrier inside a head beyond the
//      ring's.
//   3. proj: out tile (64 x 96 at a time) = ao Wproj[:, the CTA's heads]^T
//      over the ring, then + bias + x, one rounding, scattered back through
//      the offset table.
// A launch with few row tiles splits the heads over CTAs (ops/window_msa.py:
// window_msa_plan; at C = 768 the y and ao tiles of all 24 heads do not fit
// one CTA beside the ring, so there are always two splits or more).  Split
// launches write fp32 partial sums (splits, T, C) in tile-row order that
// window_msa_sum_kernel adds in split order, with the bias, the residual
// and the scatter: no atomics, so the result does not depend on the
// schedule.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W, bf16, batch
// 8, ms per call at C = 96 / 192 / 384 / 768: 0.133 / 0.076 / 0.089 / 0.101
// (78 / 132 / 111 / 96 TFLOP/s; the plain version 1.25 / 0.63 / 0.39 /
// 0.38); at batch 1 and 2 every call is 0.05-0.06 ms, of which the device
// is busy about 0.03: the rest is the wrapper's host work.  The 14 launches
// of a TULIP-base forward take 0.45 ms of device time at batch 1 and 1.49
// ms at batch 8 (14.7 and 27.7 with the FMA kernel in bf16).
// PERF.md holds the tables.
//
// fp32 (--eval_precision fp32, the default evaluation):
// window_msa_tf32_kernel, the same shape in split TF32 (mma.cuh): three
// TF32 products a product, fp32's accuracy.  The bound restates as T (8
// C^2 + 64 C) operations at 494.7 / 3 = 165 TFLOP/s.  Its differences from
// the bf16 kernel:
//   - TF32 wgmma takes K-major operands only and an fp32 tile is twice the
//     bytes, so a stage holds 32 columns: the head's three 32-row Wqkv
//     slabs (96 x 32) and the CTA's 64 x rows, gathered by cp.async
//     through the offset table (LN1 needs no y in shared memory: split_rows
//     takes the rows through it, with row_stats' fp32 statistics, as it
//     splits them); a ring of three 40 KB stages (raw, then hi and lo).
//   - qkv and proj on wgmma (m64n96k8, A and B from shared memory), each
//     32-deep tile's sum in a fresh accumulator folded into an fp32 total.
//   - The 16 x 16 logits and P V on mma.sync m16n8k8 (TF32): q's and k's
//     sum fragments are the A and B operands as they are, the head's 32
//     dimensions taken in the fragment's column order; v goes through a
//     16 x 36 float copy per warp, read back down the key tokens as the B
//     operand; the head's output to hi / lo ao tiles (64 x 32 each).
//   - At most six heads' ao tiles fit beside the ring (227 KB): C 384 and
//     768 always split the heads, and few row tiles split them further
//     (ops/window_msa.py:window_msa_plan_f32); window_msa_sum_f32_kernel
//     adds the splits in split order.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; PERF.md): one block of
// one warpgroup per SM with one tile of copies ahead; taking two thirds of
// the tensor-core products out, or the split's arithmetic, moved a
// batch-8 forward's K1 / K2 time by under 10 %.
#include "mma.cuh"

namespace tulip {

namespace tc {

constexpr int kMsaBN = 96;                   // q | k | v of one head; a proj tile
constexpr uint32_t kMsaB = kMsaBN * 128;     // bytes of a 96 x 64 weight tile
constexpr int kMsaResidentC = 1024;          // widest y kept in shared memory
constexpr uint32_t kMsaTable = kBM * 8;      // bytes of the offset table

// The token grid (B, H, W, C) cut into wh x ww windows of 16 tokens, read
// with shift (sh, sw); nW windows an image, nWw a window row; T tokens.
struct MsaGeom {
  int H, W, C, wh, ww, sh, sw, nW, nWw;
  long long T;
};

// Element offset of window-major token rg (token rg % 16 of window rg / 16,
// windows counted over the batch).
__device__ __forceinline__ long long msa_token_offset(long long rg,
                                                      const MsaGeom& g) {
  const long long wg = rg >> 4;
  const int t = (int)(rg & 15);
  const long long b = wg / g.nW;
  const int win = (int)(wg % g.nW);
  const int wi = win / g.nWw, wj = win % g.nWw;
  const int row = (wi * g.wh + t / g.ww + g.sh) % g.H;
  const int col = (wj * g.ww + t % g.ww + g.sw) % g.W;
  return ((b * g.H + row) * g.W + col) * g.C;
}

// Start the copy of a 96 x 64 weight tile: tile row 16 k + a (k < 6, a =
// thread / 8) is row row0 + (k / 2) slab + 16 (k % 2) + a of the row-major
// matrix w (ld elements a row), columns [c0, c0 + 64); rows >= rmax and
// columns >= cmax arrive as zeros.  slab 32 walks 96 consecutive rows (a
// proj tile); slab C walks a head's three 32-row slabs of wqkv.  Each
// thread's six copies differ by constants, so a tile costs it a few
// instructions.
__device__ __forceinline__ void load_tile96(uint32_t dst, const bf16* w,
                                            int ld, int row0, int slab,
                                            int rmax, int c0, int cmax) {
  const int a = threadIdx.x >> 3, ch = threadIdx.x & 7;
  const int gc = c0 + ch * 8;
  const bool cok = gc < cmax;
  const uint32_t d0 = dst + a * 128 + ((ch ^ (a & 7)) << 4);
  const bf16* p0 = w + (long long)(row0 + a) * ld + gc;
#pragma unroll
  for (int k = 0; k < kMsaBN / 16; ++k) {
    const int dr = (k >> 1) * slab + 16 * (k & 1);
    const bool ok = cok && row0 + a + dr < rmax;
    cp_async16(d0 + k * 2048, ok ? p0 + (long long)dr * ld : w, ok);
  }
}

// Start the copies of the CTA's 64 rows of x into the swizzled K-major
// tiles at ys: every 16-byte chunk from its token's address (toff, < 0: no
// such token, zeros) with cp.async, all of them in flight at once.  The
// caller commits and waits.
__device__ __forceinline__ void gather_rows(const bf16* __restrict__ x,
                                            uint32_t ys,
                                            const long long* toff, int C) {
  // chunk i = thread + 128 k of the 64 x chunks block, walked without a
  // division per chunk
  const int chunks = C / 8;
  const int dr = kWg / chunks, dc = kWg - dr * chunks;
  int r = threadIdx.x / chunks, c = threadIdx.x - r * chunks;
  for (; r < kBM; r += dr, c += dc) {
    if (c >= chunks) {
      c -= chunks;
      if (++r >= kBM) break;
    }
    const long long off = toff[r];
    cp_async16(ys + (c >> 3) * kSub + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               off >= 0 ? x + off + c * 8 : x, off >= 0);
  }
}

// y = LN1(x) in place over the 64 gathered rows at ys, for rows of NQ
// chunks of 16 bytes a lane (C <= 256 NQ): one warp per row, the row taken
// into registers, fp32 statistics in two passes over them, the result
// rounded once.  A warp takes kBatch rows at a time and reduces their sums
// side by side: shuffles keep their order, so a row alone would pay each
// one's latency in turn.  The tiles' columns beyond C are left as they
// are: no product reads them.
template <int NQ>
__device__ __forceinline__ void ln_rows_in_place(
    const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
    unsigned char* ys, int C, float eps) {
  constexpr int kWarps = kWg / 32, kBatch = NQ <= 2 ? 4 : 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = C / 8;
  float w[NQ][8], b[NQ][8];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = lane + 32 * q;
    if (c < chunks) {
      unpack8(*reinterpret_cast<const uint4*>(lnw + c * 8), w[q]);
      unpack8(*reinterpret_cast<const uint4*>(lnb + c * 8), b[q]);
    }
  }
  for (int rb = warp; rb < kBM; rb += kWarps * kBatch) {
    float v[kBatch][NQ][8];
    float sum[kBatch], sq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = rb + u * kWarps;
      sum[u] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + 32 * q;
        if (c < chunks) {
          unpack8(*reinterpret_cast<const uint4*>(
                      ys + (c >> 3) * kSub + r * 128 +
                      (((c & 7) ^ (r & 7)) << 4)),
                  v[u][q]);
#pragma unroll
          for (int i = 0; i < 8; ++i) sum[u] += v[u][q][i];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      sum[u] /= C;   // the row's mean
      sq[u] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (lane + 32 * q < chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            sq[u] += (v[u][q][i] - sum[u]) * (v[u][q][i] - sum[u]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], o);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = rb + u * kWarps;
      const float mean = sum[u], rstd = rsqrtf(sq[u] / C + eps);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + 32 * q;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[u][q][i] = (v[u][q][i] - mean) * rstd * w[q][i] + b[q][i];
          *reinterpret_cast<uint4*>(ys + (c >> 3) * kSub + r * 128 +
                                    (((c & 7) ^ (r & 7)) << 4)) =
              pack8(v[u][q]);
        }
      }
    }
  }
}

// One head of one window, in the warp that holds the window's 16 x 96
// q | k | v sums (acc, wgmma's fragment: element 4j + e is row lane / 4 +
// 8 (e / 2), column 8j + 2 (lane % 4) + e % 2).  bq: bqkv + 32 head;
// bias_h: the head's (16, 16) bias; mk: the window's mask in the logits'
// fragment order (zeros without one).  Writes the rounded 16 x 32 output to
// columns [32 hl, 32 hl + 32) of the warp's rows of the ao tiles.
__device__ __forceinline__ void attend_head(const float (&acc)[kMsaBN / 2],
                                            const bf16* __restrict__ bq,
                                            int C,
                                            const float* __restrict__ bias_h,
                                            const float (&mk)[8], float scale,
                                            unsigned char* ao, int hl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  // f[j][0]: row g, f[j][1]: row g + 8 of column pair 8j + 2 qd, as bf16
  uint32_t f[kMsaBN / 8][2];
#pragma unroll
  for (int j = 0; j < kMsaBN / 8; ++j) {
    const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(
        bq + (size_t)(j >> 2) * C + 8 * (j & 3) + 2 * qd);
    const float b0 = __low2float(bb), b1 = __high2float(bb);
    f[j][0] = pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    f[j][1] = pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  // S = q k^T: q's fragment is the A operand as it is; k's (token along
  // the fragment's rows, depth along its columns) is the B operand
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a[4] = {f[2 * ks][0], f[2 * ks][1], f[2 * ks + 1][0],
                           f[2 * ks + 1][1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma_m16n8k16(s[nt], a, f[4 + 2 * ks][nt], f[5 + 2 * ks][nt]);
  }
  float bh[8];
  load_frag16(bias_h, bh);
  window_softmax(s, bh, mk, scale);
  uint32_t p[4];   // P as the A operand of P V
  pack_a(s, p);
  // O = P V: v's 8 x 8 blocks transposed in registers give the B operand
  const int row = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    float o[4] = {};
    mma_m16n8k16(o, p, movmatrix_trans(f[8 + dt][0]),
                 movmatrix_trans(f[8 + dt][1]));
    const int col = hl * 32 + 8 * dt + 2 * qd;
    unsigned char* sub = ao + (col >> 6) * kSub;
    *reinterpret_cast<uint32_t*>(sub + swz(row, col & 63)) =
        pack_bf16(o[0], o[1]);
    *reinterpret_cast<uint32_t*>(sub + swz(row + 8, col & 63)) =
        pack_bf16(o[2], o[3]);
  }
}

// grid (row tiles of 64 window-major tokens, head splits); hs heads per
// split.  resident: y is made here and kept in shared memory; else ysrc
// (LN1(x) in window-major row order, from msa_ln_gather_kernel) is streamed
// beside Wqkv.  partial non-null: the split's fp32 sums go to
// partial[split][window-major token][C].
// The plan takes three ring stages where that lets three blocks share an
// SM (C = 96), so that instantiation is held to the registers three blocks
// leave each other (168 a thread); the four-stage one is not, since the cap
// costs it 15 % at C >= 384.
template <int STAGES>
__global__ void __launch_bounds__(kWg, STAGES == 3 ? 3 : 1)
window_msa_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ ysrc,
    bf16* __restrict__ out, float* __restrict__ partial,
    const bf16* __restrict__ lnw, const bf16* __restrict__ lnb,
    const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
    const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const MsaGeom g, int nh, int hs, int resident, float scale, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int C = g.C;
  const int ktc = (C + 63) / 64;
  const uint32_t stage_bytes = kMsaB + (resident ? 0u : kSub);
  unsigned char* ao_p = sm + STAGES * stage_bytes;     // (hs + 1) / 2 tiles
  unsigned char* ys_p = ao_p + ((hs + 1) / 2) * kSub;  // y, if resident
  long long* toff =
      reinterpret_cast<long long*>(ys_p + (resident ? ktc * kSub : 0));
  const uint32_t ring = smem_u32(sm), as = smem_u32(ao_p),
                 ys = smem_u32(ys_p);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int h0 = blockIdx.y * hs;
  const int hn = min(hs, nh - h0);                     // this CTA's heads
  if (threadIdx.x < kBM) {
    const long long rg = r0 + threadIdx.x;
    toff[threadIdx.x] = rg < g.T ? msa_token_offset(rg, g) : -1;
  }
  __syncthreads();
  if (resident) {
    gather_rows(x, ys, toff, C);
    cp_async_commit();
  }

  // the warp's window's mask, in the logits' fragment order (its loads
  // run under the gather)
  float mk[8] = {};
  if (mask) {
    const long long wg = (long long)blockIdx.x * (kBM / kRows) +
                         (threadIdx.x >> 5);
    load_frag16(mask + (size_t)(wg % g.nW) * kRows * kRows, mk);
  }

  if (resident) {
    cp_async_wait<0>();
    __syncthreads();
    const int nq = (C / 8 + 31) / 32;   // 16-byte chunks of a row per lane
    if (nq == 1) ln_rows_in_place<1>(lnw, lnb, ys_p, C, eps);
    if (nq == 2) ln_rows_in_place<2>(lnw, lnb, ys_p, C, eps);
    if (nq == 3) ln_rows_in_place<3>(lnw, lnb, ys_p, C, eps);
    if (nq == 4) ln_rows_in_place<4>(lnw, lnb, ys_p, C, eps);
  }

  const int kth = (hn * 32 + 63) / 64, ntb = (C + kMsaBN - 1) / kMsaBN;
  const int tiles_a = hn * ktc, T = tiles_a + ntb * kth;
  const int row = frag_row();
  const long long off[2] = {toff[row], toff[row + 8]};   // this thread's rows
  float acc[kMsaBN / 2];
  auto fetch = [&](int t, uint32_t st) {
    if (t < tiles_a) {      // head t / ktc: Wqkv slabs [64 j ..] (+ the rows' y)
      const int hl = t / ktc, j = t % ktc;
      load_tile96(st, wqkv, C, (h0 + hl) * 32, C, 3 * C, j * 64, C);
      if (!resident) load_tile(st + kMsaB, ysrc, C, r0, g.T, j * 64, C, kBM);
    } else {                // Wproj[96 i ..][32 h0 + 64 j ..]
      const int u = t - tiles_a, i = u / kth, j = u % kth;
      load_tile96(st, wproj, C, i * kMsaBN, 32, C, h0 * 32 + j * 64,
                  (h0 + hn) * 32);
    }
  };
  auto use = [&](int t, uint32_t st) {
    if (t < tiles_a) {
      const int hl = t / ktc, j = t % ktc;
      mma_tile<kMsaBN, 0, 0>(acc, resident ? ys + j * kSub : st + kMsaB, st,
                             min(4, (C - j * 64) / 16), j == 0);
      if (j + 1 < ktc) {
        wgmma_wait<1>();
        return;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      attend_head(acc, bqkv + (h0 + hl) * 32, C,
                  bias + (size_t)(h0 + hl) * kRows * kRows, mk, scale, ao_p,
                  hl);
    } else {
      const int u = t - tiles_a, i = u / kth, j = u % kth;
      mma_tile<kMsaBN, 0, 0>(acc, as + j * kSub, st,
                             min(4, (hn * 32 - j * 64) / 16), j == 0);
      if (j + 1 < kth) {
        wgmma_wait<1>();
        return;
      }
      // the tile's bias and residual: every load started together, under
      // the last products
      uint32_t bp[kMsaBN / 8], xr[kMsaBN / 8][2];
      if (!partial) {
#pragma unroll
        for (int jj = 0; jj < kMsaBN / 8; ++jj) {
          const int oc = i * kMsaBN + frag_col(jj);
          const bool ok = oc < C;
          bp[jj] = ok ? *reinterpret_cast<const uint32_t*>(bproj + oc) : 0u;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            xr[jj][e] = ok && off[e] >= 0 ? *reinterpret_cast<const uint32_t*>(
                                                x + off[e] + oc)
                                          : 0u;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int jj = 0; jj < kMsaBN / 8; ++jj) {
        const int oc = i * kMsaBN + frag_col(jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (oc >= C || off[e] < 0) continue;
          float v0 = acc[4 * jj + 2 * e], v1 = acc[4 * jj + 2 * e + 1];
          if (partial) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.y * g.T + r0 + row + 8 * e) * C +
                oc) = make_float2(v0, v1);
            continue;
          }
          const __nv_bfloat162 b2 =
              *reinterpret_cast<const __nv_bfloat162*>(&bp[jj]);
          const __nv_bfloat162 x2 =
              *reinterpret_cast<const __nv_bfloat162*>(&xr[jj][e]);
          v0 = v0 + __low2float(b2) + __low2float(x2);
          v1 = v1 + __high2float(b2) + __high2float(x2);
          *reinterpret_cast<uint32_t*>(out + off[e] + oc) = pack_bf16(v0, v1);
        }
      }
    }
  };
  stream_tiles<STAGES>(ring, stage_bytes, T, fetch, use);
}

// out = round(sum over splits, in split order, + bproj + x) at each token's
// own position: four columns per thread.
__global__ void __launch_bounds__(kThreads) window_msa_sum_kernel(
    const float* __restrict__ partial, const bf16* __restrict__ x,
    const bf16* __restrict__ bproj, bf16* __restrict__ out, const MsaGeom g,
    int splits) {
  const long long total = g.T * g.C;
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (idx >= total) return;
  const int c = (int)(idx % g.C);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 p =
        *reinterpret_cast<const float4*>(partial + (size_t)s * total + idx);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const long long off = msa_token_offset(idx / g.C, g) + c;
  const uint2 braw = *reinterpret_cast<const uint2*>(bproj + c);
  const uint2 xraw = *reinterpret_cast<const uint2*>(x + off);
  const bf16* b = reinterpret_cast<const bf16*>(&braw);
  const bf16* xr = reinterpret_cast<const bf16*>(&xraw);
  *reinterpret_cast<uint2*>(out + off) = make_uint2(
      pack_bf16(v.x + to_f(b[0]) + to_f(xr[0]),
                v.y + to_f(b[1]) + to_f(xr[1])),
      pack_bf16(v.z + to_f(b[2]) + to_f(xr[2]),
                v.w + to_f(b[3]) + to_f(xr[3])));
}

// y[window-major token] = LN1(x[token]) for the rows too wide to stay in
// shared memory: one warp per row.
__global__ void __launch_bounds__(kThreads) msa_ln_gather_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const bf16* __restrict__ lnb, bf16* __restrict__ y, const MsaGeom g,
    float eps) {
  const long long rg = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (rg >= g.T) return;
  ln_one_row(x + msa_token_offset(rg, g), lnw, lnb, y + rg * g.C, g.C, eps);
}

// Plan (ops/window_msa.py:window_msa_plan): hs heads per split, splits,
// ring stages, smem bytes.  The launch is refused, not reshaped, when the
// plan and the kernel's needs differ.
cudaError_t launch_window_msa_tc(const bf16* x, bf16* out, bf16* y,
                                 float* partial, const bf16* lnw,
                                 const bf16* lnb, const bf16* wqkv,
                                 const bf16* bqkv, const bf16* wproj,
                                 const bf16* bproj, const float* bias,
                                 const float* mask, int B, int H, int W, int C,
                                 int nh, int wh, int ww, int sh, int sw,
                                 float scale, float eps, int hs, int splits,
                                 int stages, int smem, cudaStream_t stream) {
  if (wh * ww != kRows || C != nh * 32 || B <= 0 || H <= 0 || W <= 0 ||
      H % wh || W % ww || hs <= 0 || splits != (nh + hs - 1) / hs ||
      splits > 65535 || (splits > 1) != (partial != nullptr))
    return cudaErrorInvalidValue;
  const int resident = C <= kMsaResidentC;
  if (!resident && !y) return cudaErrorInvalidValue;
  const uint32_t stage = kMsaB + (resident ? 0u : kSub);
  const size_t need = 1024 + (size_t)stages * stage +
                      (size_t)((hs + 1) / 2) * kSub +
                      (resident ? (size_t)((C + 63) / 64) * kSub : 0) +
                      kMsaTable;
  if ((size_t)smem != need) return cudaErrorInvalidValue;
  MsaGeom g;
  g.H = H, g.W = W, g.C = C, g.wh = wh, g.ww = ww, g.sh = sh, g.sw = sw;
  g.nWw = W / ww, g.nW = (H / wh) * g.nWw;
  g.T = (long long)B * H * W;
  cudaError_t err;
  if (!resident) {
    msa_ln_gather_kernel<<<(unsigned)((g.T + kLnRows - 1) / kLnRows),
                           kThreads, 0, stream>>>(x, lnw, lnb, y, g, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((g.T + kBM - 1) / kBM), splits);
#define TULIP_MSA_TC(S)                                                      \
  if ((err = prepare_smem(window_msa_tc_kernel<S>, need)) != cudaSuccess)    \
    return err;                                                              \
  window_msa_tc_kernel<S><<<grid, kWg, need, stream>>>(                      \
      x, y, out, partial, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, g, \
      nh, hs, resident, scale, eps)
  if (stages == 3) {
    TULIP_MSA_TC(3);
  } else if (stages == 4) {
    TULIP_MSA_TC(4);
  } else {
    return cudaErrorInvalidValue;
  }
#undef TULIP_MSA_TC
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long quads = g.T * C / 4;
  window_msa_sum_kernel<<<(unsigned)((quads + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(partial, x, bproj, out, g,
                                                 splits);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// fp32: window_msa_tf32_kernel, split TF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMsaF32Stages = 3;             // ring stages
constexpr uint32_t kMsaF32W = kMsaBN * 128;  // 96 rows x 32 fp32
constexpr uint32_t kMsaF32Half = kMsaF32W + kBM * 128;   // W + x rows: hi
constexpr uint32_t kMsaF32Stage = 2 * kMsaF32Half;       // + lo
constexpr uint32_t kMsaF32Head = 2 * kSub;   // a head's ao tiles, hi + lo
constexpr int kMsaVStride = 36;              // floats a row of a warp's V
constexpr uint32_t kMsaF32V = (kWg / 32) * kRows * kMsaVStride * 4;
constexpr uint32_t kMsaF32Fixed =            // all but the ao tiles
    1024 + kMsaF32Stages * kMsaF32Stage + kMsaF32V + kBM * 8 + kMsaTable;

// One head of one window in fp32, in the warp that holds the window's 16 x
// 96 q | k | v sums (acc, wgmma's fragment as in attend_head).  S = q k^T
// takes q's fragment as the A operand and k's as the B operand as they
// are, the head's 32 dimensions in the order of a sum fragment (mma.cuh);
// v goes through the warp's 16 x 36 float buffer vb, read back as the B
// operand of P V (key tokens down, dimensions across, as mma.sync wants);
// P's fragment is the A operand as it is, the key tokens taken in the same
// order in both.  Every product is split TF32 (mma3_sync).  The 16 x 32
// output goes, as hi and lo, to the warp's rows of the head's ao tiles at
// ao (hi) and ao + kSub (lo).
__device__ __forceinline__ void attend_head_f32(
    const float (&acc)[kMsaBN / 2], const float* __restrict__ bq, int C,
    const float* __restrict__ bias_h, const float (&mk)[8], float scale,
    unsigned char* ao, float* vb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  // f[j][e]: row g + 8 (e / 2), column 8 j + 2 qd + e % 2 of q | k | v
  float f[kMsaBN / 8][4];
#pragma unroll
  for (int j = 0; j < kMsaBN / 8; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(
        bq + (size_t)(j >> 2) * C + 8 * (j & 3) + 2 * qd);
    f[j][0] = acc[4 * j] + bb.x;
    f[j][1] = acc[4 * j + 1] + bb.y;
    f[j][2] = acc[4 * j + 2] + bb.x;
    f[j][3] = acc[4 * j + 3] + bb.y;
  }
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    *reinterpret_cast<float2*>(vb + g * kMsaVStride + 8 * dt + 2 * qd) =
        make_float2(f[8 + dt][0], f[8 + dt][1]);
    *reinterpret_cast<float2*>(vb + (g + 8) * kMsaVStride + 8 * dt + 2 * qd) =
        make_float2(f[8 + dt][2], f[8 + dt][3]);
  }
  __syncwarp();
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float a[4] = {f[ks][0], f[ks][2], f[ks][1], f[ks][3]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma3_sync(s[nt], a, f[4 + ks][2 * nt], f[4 + ks][2 * nt + 1]);
  }
  float bh[8];
  load_frag16(bias_h, bh);
  window_softmax(s, bh, mk, scale);
  float o[4][4] = {};
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const float a[4] = {s[kt][0], s[kt][2], s[kt][1], s[kt][3]};
    const float* v0 = vb + (8 * kt + 2 * qd) * kMsaVStride + g;
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
      mma3_sync(o[dt], a, v0[8 * dt], v0[kMsaVStride + 8 * dt]);
  }
  __syncwarp();   // vb is read before the next head writes it
  const int row = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * qd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t h0, l0, h1, l1;
      split_tf32(o[dt][2 * h], h0, l0);
      split_tf32(o[dt][2 * h + 1], h1, l1);
      const uint32_t off = swz32(row + 8 * h, col);
      *reinterpret_cast<uint2*>(ao + off) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(ao + kSub + off) = make_uint2(l0, l1);
    }
  }
}

// grid (row tiles of 64 window-major tokens, head splits); hs heads per
// split.  The x rows stream through the ring beside the weights (each
// qkv tile: the head's three 32-row Wqkv slabs and the 64 gathered rows,
// 32 columns of each), and split_rows takes them through LN1 (statistics
// from row_stats) while it splits them.  partial non-null: the split's
// fp32 sums go to partial[split][window-major token][C].
__global__ void __launch_bounds__(kWg, 1) window_msa_tf32_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    float* __restrict__ partial, const float* __restrict__ lnw,
    const float* __restrict__ lnb, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ bias,
    const float* __restrict__ mask, const MsaGeom g, int nh, int hs,
    float scale, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int C = g.C;
  const int ktc = C / 32;
  unsigned char* ao_p = sm + kMsaF32Stages * kMsaF32Stage;
  float* vb = reinterpret_cast<float*>(ao_p + hs * kMsaF32Head) +
              (threadIdx.x >> 5) * kRows * kMsaVStride;
  float* stat = reinterpret_cast<float*>(ao_p + hs * kMsaF32Head + kMsaF32V);
  long long* toff = reinterpret_cast<long long*>(stat + 2 * kBM);
  const uint32_t ring = smem_u32(sm), as = smem_u32(ao_p);

  const long long r0 = (long long)blockIdx.x * kBM;
  const int h0 = blockIdx.y * hs;
  const int hn = min(hs, nh - h0);                     // this CTA's heads
  if (threadIdx.x < kBM) {
    const long long rg = r0 + threadIdx.x;
    toff[threadIdx.x] = rg < g.T ? msa_token_offset(rg, g) : -1;
  }
  __syncthreads();
  row_stats([&](int r) { return toff[r] >= 0 ? x + toff[r] : nullptr; }, C,
            eps, stat);
  __syncthreads();
  float2 st_ln[2];
  thread_stats(stat, st_ln);
  float mk[8] = {};
  if (mask) {
    const long long wg = (long long)blockIdx.x * (kBM / kRows) +
                         (threadIdx.x >> 5);
    load_frag16(mask + (size_t)(wg % g.nW) * kRows * kRows, mk);
  }

  const int ntb = (C + kMsaBN - 1) / kMsaBN;
  const int tiles_a = hn * ktc, T = tiles_a + ntb * hn;
  const int row = frag_row();
  const long long off[2] = {toff[row], toff[row + 8]};   // this thread's rows
  // each tile's products go to a fresh accumulator, one of two that
  // alternate, added to total once they end (fold)
  float acc_a[kMsaBN / 2], acc_b[kMsaBN / 2], total[kMsaBN / 2];
  auto fetch = [&](int t, uint32_t st) {
    if (t < tiles_a) {   // head t / ktc: Wqkv slabs, x rows; columns 32 j ..
      const int hl = t / ktc, j = t % ktc;
      load_tile_f32(st, wqkv, C, (h0 + hl) * 32, C, 3 * C, j * 32, C,
                    kMsaBN);
      for (int i = threadIdx.x; i < kBM * 8; i += kWg) {
        const int r = i >> 3, ch = i & 7;
        const long long o = toff[r];
        cp_async16(st + kMsaF32W + r * 128 + ((ch ^ (r & 7)) << 4),
                   o >= 0 ? x + o + j * 32 + ch * 4 : x, o >= 0);
      }
    } else {             // out tile u / hn: Wproj rows 96 i .., head's columns
      const int u = t - tiles_a, i = u / hn, hl = u % hn;
      load_tile_f32(st, wproj, C, i * kMsaBN, 32, C, (h0 + hl) * 32, C,
                    kMsaBN);
    }
  };
  auto split = [&](int t, uint32_t st_addr) {
    unsigned char* st = sm + (st_addr - ring);
    split_rows(st, kMsaBN, kMsaF32Half, false);
    if (t < tiles_a)
      split_rows_ln(st + kMsaF32W, kMsaF32Half, st_ln, lnw, lnb,
                    (t % ktc) * 32);
  };
  auto use = [&](int t, uint32_t st) {
    if (t < tiles_a) {
      const int hl = t / ktc, j = t % ktc;
      const uint32_t x_hi = st + kMsaF32W, x_lo = x_hi + kMsaF32Half;
      const bool last = j + 1 == ktc;
      if (j & 1)
        mma3_fold<kMsaBN>(total, acc_b, acc_a, x_hi, x_lo, st,
                          st + kMsaF32Half, j == 0, last);
      else
        mma3_fold<kMsaBN>(total, acc_a, acc_b, x_hi, x_lo, st,
                          st + kMsaF32Half, j == 0, last);
      if (!last) return;
      attend_head_f32(total, bqkv + (h0 + hl) * 32, C,
                      bias + (size_t)(h0 + hl) * kRows * kRows, mk, scale,
                      ao_p + hl * kMsaF32Head, vb);
    } else {
      const int u = t - tiles_a, i = u / hn, hl = u % hn;
      const uint32_t a_hi = as + hl * kMsaF32Head, a_lo = a_hi + kSub;
      const bool last = hl + 1 == hn;
      if (hl & 1)
        mma3_fold<kMsaBN>(total, acc_b, acc_a, a_hi, a_lo, st,
                          st + kMsaF32Half, hl == 0, last);
      else
        mma3_fold<kMsaBN>(total, acc_a, acc_b, a_hi, a_lo, st,
                          st + kMsaF32Half, hl == 0, last);
      if (!last) return;
#pragma unroll
      for (int jj = 0; jj < kMsaBN / 8; ++jj) {
        const int oc = i * kMsaBN + frag_col(jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (oc >= C || off[e] < 0) continue;
          float v0 = total[4 * jj + 2 * e], v1 = total[4 * jj + 2 * e + 1];
          if (partial) {
            *reinterpret_cast<float2*>(
                partial + ((size_t)blockIdx.y * g.T + r0 + row + 8 * e) * C +
                oc) = make_float2(v0, v1);
            continue;
          }
          const float2 b2 = *reinterpret_cast<const float2*>(bproj + oc);
          const float2 x2 = *reinterpret_cast<const float2*>(x + off[e] + oc);
          *reinterpret_cast<float2*>(out + off[e] + oc) =
              make_float2(v0 + b2.x + x2.x, v1 + b2.y + x2.y);
        }
      }
    }
  };
  stream_split_tiles<kMsaF32Stages>(ring, kMsaF32Stage, T, fetch, split,
                                    use);
}

// out = sum over splits, in split order, + bproj + x at each token's own
// position, fp32: four columns per thread.
__global__ void __launch_bounds__(kThreads) window_msa_sum_f32_kernel(
    const float* __restrict__ partial, const float* __restrict__ x,
    const float* __restrict__ bproj, float* __restrict__ out, const MsaGeom g,
    int splits) {
  const long long total = g.T * g.C;
  const long long idx =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (idx >= total) return;
  const int c = (int)(idx % g.C);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 p =
        *reinterpret_cast<const float4*>(partial + (size_t)s * total + idx);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const long long off = msa_token_offset(idx / g.C, g) + c;
  const float4 b = *reinterpret_cast<const float4*>(bproj + c);
  const float4 xr = *reinterpret_cast<const float4*>(x + off);
  *reinterpret_cast<float4*>(out + off) =
      make_float4(v.x + b.x + xr.x, v.y + b.y + xr.y, v.z + b.z + xr.z,
                  v.w + b.w + xr.w);
}

// Plan (ops/window_msa.py:window_msa_plan_f32): hs heads per split,
// splits, ring stages (3), smem bytes.  Refused, not reshaped, where the
// plan and the kernel's needs differ.
cudaError_t launch_window_msa_tf32(const float* x, float* out, float* partial,
                                   const float* lnw, const float* lnb,
                                   const float* wqkv, const float* bqkv,
                                   const float* wproj, const float* bproj,
                                   const float* bias, const float* mask,
                                   int B, int H, int W, int C, int nh, int wh,
                                   int ww, int sh, int sw, float scale,
                                   float eps, int hs, int splits, int stages,
                                   int smem, cudaStream_t stream) {
  if (wh * ww != kRows || C != nh * 32 || B <= 0 || H <= 0 || W <= 0 ||
      H % wh || W % ww || hs <= 0 || splits != (nh + hs - 1) / hs ||
      splits > 65535 || (splits > 1) != (partial != nullptr) ||
      stages != kMsaF32Stages)
    return cudaErrorInvalidValue;
  const size_t need = kMsaF32Fixed + (size_t)hs * kMsaF32Head;
  if ((size_t)smem != need) return cudaErrorInvalidValue;
  MsaGeom g;
  g.H = H, g.W = W, g.C = C, g.wh = wh, g.ww = ww, g.sh = sh, g.sw = sw;
  g.nWw = W / ww, g.nW = (H / wh) * g.nWw;
  g.T = (long long)B * H * W;
  cudaError_t err = prepare_smem(window_msa_tf32_kernel, need);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.T + kBM - 1) / kBM), splits);
  window_msa_tf32_kernel<<<grid, kWg, need, stream>>>(
      x, out, partial, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, g, nh,
      hs, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long quads = g.T * C / 4;
  window_msa_sum_f32_kernel<<<(unsigned)((quads + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(partial, x, bproj, out,
                                                     g, splits);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// fp32: the split-TF32 kernel under the plan (hs, splits, stages, smem);
// y is not read.  bf16: the tensor-core kernel under that plan.
extern "C" int tulip_window_msa(int dtype, const void* x, void* out,
                                const void* lnw, const void* lnb,
                                const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj,
                                const void* bias, const void* mask, void* y,
                                void* partial, int B, int H, int W, int C,
                                int nh, int wh, int ww, int sh, int sw,
                                float scale, float eps, int hs, int splits,
                                int stages, int smem, void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::tc::launch_window_msa_tf32(
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(partial), static_cast<const float*>(lnw),
        static_cast<const float*>(lnb), static_cast<const float*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
        static_cast<const float*>(bproj), static_cast<const float*>(bias),
        static_cast<const float*>(mask), B, H, W, C, nh, wh, ww, sh, sw,
        scale, eps, hs, splits, stages, smem, s);
  if (dtype == 1)
    return tulip::tc::launch_window_msa_tc(
        static_cast<const bf16*>(x), static_cast<bf16*>(out),
        static_cast<bf16*>(y), static_cast<float*>(partial),
        static_cast<const bf16*>(lnw), static_cast<const bf16*>(lnb),
        static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
        static_cast<const bf16*>(wproj), static_cast<const bf16*>(bproj),
        static_cast<const float*>(bias), static_cast<const float*>(mask), B, H,
        W, C, nh, wh, ww, sh, sw, scale, eps, hs, splits, stages, smem, s);
  return cudaErrorInvalidValue;
}

// xg: (windows, 16, C) window-major tokens (the (B, nG, 128, C) grouped
// layout viewed flat), windows % nW == 0; mask (nW, 16, 16) or null
extern "C" int tulip_window_msa_grouped(
    int dtype, const void* xg, void* out, const void* lnw, const void* lnb,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* bias, const void* mask, void* y, void* partial, int windows,
    int nW, int C, int nh, float scale, float eps, int hs, int splits,
    int stages, int smem, void* stream) {
  if (nW <= 0 || windows <= 0 || windows % nW) return cudaErrorInvalidValue;
  return tulip_window_msa(dtype, xg, out, lnw, lnb, wqkv, bqkv, wproj, bproj,
                          bias, mask, y, partial, windows / nW, nW,
                          tulip::kRows, C, nh, 1, tulip::kRows, 0, 0, scale,
                          eps, hs, splits, stages, smem, stream);
}

extern "C" const char* tulip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
