// LayerNorm over the last axis of an (N, C) token matrix, forward and
// backward.
//
// Replaces: tulip_tpu/ops/pallas/ln.py:_fwd_kernel (K14) and
// ln.py:_bwd_kernel (K15) (the opt-in norm1 of the training block,
// layer_norm_vjp).
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
//
// bf16 (ln_fwd_reg_kernel, ln_bwd_reg_kernel): rows held in registers.  A
// row of C bf16 is C / 8 chunks of 16 bytes; a group of L lanes takes a
// row, lane s of the group chunks s, s + L, s + 2L, ... (CPL chunks, the
// last masked where L does not divide C / 8), so one load instruction of
// the warp reads 32 / L rows' L * 16 contiguous bytes each.  x (and g) are
// read once, in 16-byte loads; the statistics come from the registers by
// shuffles inside the group (xor offsets < L); y / dx leave in 16-byte
// stores.  w and b are the same for every row a lane visits: the forward
// holds its lane's columns of them in registers, the backward reads w from
// shared memory (its registers hold the dw / db sums).  The grid is
// persistent, two CTAs an SM at the step's widths: CTA i takes the
// contiguous rows [i * rows_per_cta, (i + 1) * rows_per_cta), its warps
// walk them 32 / L rows at a time, and each warp issues the loads of its
// next rows before it computes the current ones.  The launch plan (lanes,
// rows per CTA, CTAs, CTAs per group) is ops/ln.py:ln_plan; the entry
// points check it.
// The backward keeps each lane's dw / db sums for its columns in
// registers, adds them over the warp's row groups by shuffles (xor offsets
// >= L), over the CTA's warps in warp order through one shared-memory row
// per warp, and writes one (2, C) fp32 partial per CTA.  The column sums
// end in the same launch, in two levels of tickets from device counters:
// the CTA that draws the last ticket of its group of ~sqrt(CTAs) adds the
// group's partials in CTA order; the one of those that draws the last
// group ticket adds the group sums in group order, writes dw and db, and
// every counter is reset by the CTA that drew its last ticket.  Every sum
// runs in a fixed order, so the result is bit-for-bit repeatable; only
// which CTA adds varies.  (One level, the last CTA adding all partials,
// left that CTA reading up to 1.6 MB alone, and fewer CTAs to keep it
// short left the warps' row loops latency-bound.)
//
// fp32 (ln_fwd_kernel, ln_bwd_kernel): the parity path, one warp per row,
// lanes strided over the columns, three passes over the row (L1 holds it);
// the backward writes one (2, C) partial per block, summed by
// tulip_colsum (reduce.cu) in block order.
#include <cstdint>

#include "common.cuh"

namespace tulip {

constexpr int kLnWarps = kThreads / 32;   // warps per block

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

cudaError_t launch_ln_fwd_f32(const float* x, const float* w, const float* b,
                              float* y, long long N, int C, float eps,
                              cudaStream_t stream) {
  if (N <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long blocks = (N + kLnWarps - 1) / kLnWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ln_fwd_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, w, b, y, N, C, eps);
  return cudaGetLastError();
}

cudaError_t launch_ln_bwd_f32(const float* x, const float* w, const float* g,
                              float* dx, float* part, long long N, int C,
                              int rows_per_block, float eps,
                              cudaStream_t stream) {
  if (N <= 0 || C <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kLnWarps * 2 * (size_t)C;
  cudaError_t err = prepare_smem(ln_bwd_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<float><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, g, dx, part, N, C, rows_per_block, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: rows in registers

namespace lnr {

using bf16 = __nv_bfloat16;

constexpr int kMaxCpl = 6;   // 16-byte chunks a lane at most: C <= 1,536

// CTAs per SM each kernel is built for (a thread may take 65,536 / (256 x
// CTAs) registers); ops/ln.py:_blocks_per_sm mirrors this
template <int CPL> constexpr int blocks_per_sm() { return CPL <= 3 ? 2 : 1; }

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                    pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// the 8 fp32 values of chunk j of v (zeros where j is past the row's end);
// v 16-byte aligned
__device__ __forceinline__ void cols8(const float* v, int j, int chunks,
                                      float (&o)[8]) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* v4 = reinterpret_cast<const float4*>(v) + 2 * j;
  const float4 a = j < chunks ? v4[0] : z, b = j < chunks ? v4[1] : z;
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// sums over the L lanes of a row's group (xor offsets 1, 2, ..., L / 2)
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ void group_sum2(float& a, float& b, int L) {
  for (int o = 1; o < L; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// The lane's chunks of row r (zeros where r >= r1 or the chunk is past the
// row's end).
template <int CPL>
__device__ __forceinline__ void load_row(uint4 (&v)[CPL],
                                         const bf16* __restrict__ base,
                                         long long r, long long r1,
                                         int chunks, int L, int sub) {
  const uint4* row = reinterpret_cast<const uint4*>(base) + r * chunks;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = k * L + sub;
    v[k] = (r < r1 && j < chunks) ? __ldg(row + j) : make_uint4(0, 0, 0, 0);
  }
}

// mean and 1/std of the group's row from the lane's chunks
template <int CPL>
__device__ __forceinline__ void stats(const uint4 (&xv)[CPL], int C,
                                      int chunks, int L, int sub, float eps,
                                      float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float f[8];
    unpack8(xv[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  mean = group_sum(s, L) / C;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (k * L + sub >= chunks) continue;
    float f[8];
    unpack8(xv[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mean;
      q += d * d;
    }
  }
  rstd = rsqrtf(group_sum(q, L) / C + eps);
}

template <int CPL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<CPL>())
    ln_fwd_reg_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, bf16* __restrict__ y,
                      long long N, int C, int L, long long rows_per_cta,
                      float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (L - 1), grp = lane / L, rows = 32 / L;
  const int chunks = C / 8;
  float wr[CPL][8], br[CPL][8];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    cols8(w, k * L + sub, chunks, wr[k]);
    cols8(b, k * L + sub, chunks, br[k]);
  }
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(N, r0 + rows_per_cta);
  const long long step = (long long)kLnWarps * rows;
  long long base = r0 + (long long)warp * rows;   // warp-uniform
  uint4 cur[CPL];
  load_row(cur, x, base + grp, r1, chunks, L, sub);
  for (; base < r1; base += step) {
    const long long r = base + grp;
    uint4 nxt[CPL];
    load_row(nxt, x, r + step, r1, chunks, L, sub);
    float mean, rstd;
    stats(cur, C, chunks, L, sub, eps, mean, rstd);
    uint4* yr = reinterpret_cast<uint4*>(y) + r * chunks;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      float f[8];
      unpack8(cur[k], f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = (f[i] - mean) * rstd * wr[k][i] + br[k][i];
      if (r < r1 && j < chunks) yr[j] = pack8(f);
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) cur[k] = nxt[k];
  }
}

// The CTA's ticket of a counter that n CTAs draw from: true in the CTA that
// draws the last one, whose later reads then see every write the others
// made before they drew theirs.
__device__ __forceinline__ bool last_ticket(unsigned* counter, unsigned n,
                                            bool& last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[c] = sum over rows p in [p0, p1), in order, of src[p][c]: (rows, m4)
// float4 matrices, read past L1 (other CTAs wrote them)
__device__ __forceinline__ void sum_rows(const float4* src, int p0, int p1,
                                         int m4, float4* dst) {
  constexpr int kBatch = 8;   // loads in flight a thread
  for (int c = threadIdx.x; c < m4; c += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = p0; p < p1; p += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p + u < p1) v[u] = __ldcg(src + (size_t)(p + u) * m4 + c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p + u < p1) add4(acc, v[u]);
    }
    dst[c] = acc;
  }
}

// part: (gridDim.x, 2C) and gpart: (ceil(gridDim.x / group), 2C) fp32
// scratch; tickets: 1 + ceil(gridDim.x / group) counters, 0 before the
// launch and left 0 after it; dwdb: (2, C), the result [dw; db]
template <int CPL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<CPL>())
    ln_bwd_reg_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                      const bf16* __restrict__ g, bf16* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ gpart,
                      unsigned* __restrict__ tickets,
                      float* __restrict__ dwdb, long long N, int C, int L,
                      long long rows_per_cta, int group, float eps) {
  // w (C floats), then one [dw | db] row (2C floats) per warp
  extern __shared__ float4 smem4[];
  const float* wsm = reinterpret_cast<const float*>(smem4);
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (L - 1), grp = lane / L, rows = 32 / L;
  const int chunks = C / 8;
  // w from shared memory: in registers it would leave too few for two CTAs
  // an SM beside the row chunks and the dw / db sums
  for (int c = threadIdx.x; c < C / 4; c += kThreads)
    smem4[c] = __ldg(reinterpret_cast<const float4*>(w) + c);
  __syncthreads();
  float dwa[CPL][8], dba[CPL][8];
#pragma unroll
  for (int k = 0; k < CPL; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) dwa[k][i] = dba[k][i] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(N, r0 + rows_per_cta);
  const long long step = (long long)kLnWarps * rows;
  long long base = r0 + (long long)warp * rows;   // warp-uniform
  uint4 xc[CPL], gc[CPL];
  load_row(xc, x, base + grp, r1, chunks, L, sub);
  load_row(gc, g, base + grp, r1, chunks, L, sub);
  for (; base < r1; base += step) {
    const long long r = base + grp;
    uint4 xn[CPL], gn[CPL];
    load_row(xn, x, r + step, r1, chunks, L, sub);
    load_row(gn, g, r + step, r1, chunks, L, sub);
    float mean, rstd;
    stats(xc, C, chunks, L, sub, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      float xf[8], gf[8], wv[8];
      unpack8(xc[k], xf);
      unpack8(gc[k], gf);
      cols8(wsm, k * L + sub, chunks, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (xf[i] - mean) * rstd;
        const float t = gf[i] * wv[i];
        s1 += t;
        s2 += t * xh;
        dwa[k][i] += gf[i] * xh;
        dba[k][i] += gf[i];
      }
    }
    group_sum2(s1, s2, L);
    const float m1 = s1 / C, m2 = s2 / C;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + r * chunks;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      float xf[8], gf[8], wv[8];
      unpack8(xc[k], xf);
      unpack8(gc[k], gf);
      cols8(wsm, j, chunks, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (xf[i] - mean) * rstd;
        xf[i] = rstd * (gf[i] * wv[i] - m1 - xh * m2);
      }
      if (r < r1 && j < chunks) dxr[j] = pack8(xf);
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      xc[k] = xn[k];
      gc[k] = gn[k];
    }
  }
  // the warp's row groups: lanes of one column set are L apart (one level
  // of the butterfly for every sum at a time: 16 CPL independent shuffles)
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dwa[k][i] += __shfl_xor_sync(0xffffffffu, dwa[k][i], o);
        dba[k][i] += __shfl_xor_sync(0xffffffffu, dba[k][i], o);
      }
  }
  // the CTA's warps: each writes its sums to its own [dw | db] row, then
  // each column adds the rows in warp order into the CTA's partial
  const int m4 = C / 2;   // float4 columns of a (2, C) row
  float4* slab = smem4 + C / 4 + warp * m4;
  if (lane < L) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      if (j >= chunks) continue;
      slab[2 * j] = make_float4(dwa[k][0], dwa[k][1], dwa[k][2], dwa[k][3]);
      slab[2 * j + 1] =
          make_float4(dwa[k][4], dwa[k][5], dwa[k][6], dwa[k][7]);
      slab[C / 4 + 2 * j] =
          make_float4(dba[k][0], dba[k][1], dba[k][2], dba[k][3]);
      slab[C / 4 + 2 * j + 1] =
          make_float4(dba[k][4], dba[k][5], dba[k][6], dba[k][7]);
    }
  }
  __syncthreads();
  // then the CTAs: the last of each group of `group` CTAs adds the group's
  // partials in CTA order, and the last of those adds the group sums in
  // group order
  float4* part4 = reinterpret_cast<float4*>(part);
  float4* gpart4 = reinterpret_cast<float4*>(gpart);
  for (int c = threadIdx.x; c < m4; c += kThreads) {
    const float4* col = smem4 + C / 4 + c;
    float4 acc = col[0];
#pragma unroll
    for (int wp = 1; wp < kLnWarps; ++wp) add4(acc, col[wp * m4]);
    part4[(size_t)blockIdx.x * m4 + c] = acc;
  }
  const int P = gridDim.x, gi = blockIdx.x / group;
  const int ngroups = (P + group - 1) / group;
  const int p0 = gi * group, p1 = min(P, p0 + group);
  if (!last_ticket(tickets + 1 + gi, p1 - p0, last)) return;
  sum_rows(part4, p0, p1, m4, gpart4 + (size_t)gi * m4);
  if (threadIdx.x == 0) tickets[1 + gi] = 0u;   // ready for the next launch
  if (!last_ticket(tickets, ngroups, last)) return;
  sum_rows(gpart4, 0, ngroups, m4, reinterpret_cast<float4*>(dwdb));
  if (threadIdx.x == 0) tickets[0] = 0u;
}

// the plan's invariants (ops/ln.py:ln_plan); false where it is not one
inline bool plan_ok(long long N, int C, int L, long long rows_per_cta,
                    int ctas, int& cpl) {
  if (N <= 0 || C <= 0 || C % 8 || L <= 0 || L > 32 || (L & (L - 1)) ||
      ctas <= 0 || rows_per_cta <= 0 || rows_per_cta % (32 / L))
    return false;
  const int chunks = C / 8;
  cpl = (chunks + L - 1) / L;
  return cpl <= kMaxCpl && (long long)ctas * rows_per_cta >= N &&
         (long long)(ctas - 1) * rows_per_cta < N;
}

template <int CPL>
cudaError_t fwd(const void* x, const float* w, const float* b, void* y,
                long long N, int C, int L, long long rows_per_cta, int ctas,
                float eps, cudaStream_t stream) {
  ln_fwd_reg_kernel<CPL><<<ctas, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), w, b, static_cast<bf16*>(y), N, C, L,
      rows_per_cta, eps);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t bwd(const void* x, const float* w, const void* g, void* dx,
                float* part, float* gpart, unsigned* tickets, float* dwdb,
                long long N, int C, int L, long long rows_per_cta, int ctas,
                int group, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (1 + 2 * kLnWarps) * C;
  if (smem > 48 * 1024) {
    cudaError_t err = prepare_smem(ln_bwd_reg_kernel<CPL>, smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_reg_kernel<CPL><<<ctas, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), part, gpart, tickets, dwdb, N, C, L,
      rows_per_cta, group, eps);
  return cudaGetLastError();
}

}  // namespace lnr

}  // namespace tulip

// dtype of x, y, g and dx: 0 fp32, 1 bf16; w, b, part, gpart and dwdb are
// fp32.  bf16 takes the plan of ops/ln.py:ln_plan (lanes per row, rows per
// CTA, CTAs, CTAs per group of the backward's sum), refuses one that breaks
// its invariants, and reads w and b in 16-byte pieces (16-byte aligned);
// fp32 ignores the plan.
#define TULIP_LN_CPL(F, ...)                              \
  switch (cpl) {                                          \
    case 1: return tulip::lnr::F<1>(__VA_ARGS__);         \
    case 2: return tulip::lnr::F<2>(__VA_ARGS__);         \
    case 3: return tulip::lnr::F<3>(__VA_ARGS__);         \
    case 4: return tulip::lnr::F<4>(__VA_ARGS__);         \
    case 5: return tulip::lnr::F<5>(__VA_ARGS__);         \
    case 6: return tulip::lnr::F<6>(__VA_ARGS__);         \
    default: return cudaErrorInvalidValue;                \
  }

extern "C" int tulip_ln_fwd(int dtype, const void* x, const void* w,
                            const void* b, void* y, long long N, int C,
                            int lanes, long long rows_per_cta, int ctas,
                            float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(b);
  if (dtype == 0)
    return tulip::launch_ln_fwd_f32(static_cast<const float*>(x), wf, bf,
                                    static_cast<float*>(y), N, C, eps, s);
  int cpl = 0;
  if (dtype != 1 ||
      !tulip::lnr::plan_ok(N, C, lanes, rows_per_cta, ctas, cpl))
    return cudaErrorInvalidValue;
  TULIP_LN_CPL(fwd, x, wf, bf, y, N, C, lanes, rows_per_cta, ctas, eps, s)
}

// fp32: part (blocks, 2, C) of rows_per_cta rows each, summed by
// tulip_colsum; gpart, tickets and dwdb unused.  bf16: part (ctas, 2C) and
// gpart (ceil(ctas / group), 2C) scratch, tickets 1 + ceil(ctas / group)
// device counters that are 0 before the launch and after it, dwdb (2, C)
// the result [dw; db].
extern "C" int tulip_ln_bwd(int dtype, const void* x, const void* w,
                            const void* g, void* dx, void* part, void* gpart,
                            void* tickets, void* dwdb, long long N, int C,
                            int lanes, long long rows_per_cta, int ctas,
                            int group, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto p = static_cast<float*>(part);
  if (dtype == 0) {
    if (rows_per_cta > 2147483647LL) return cudaErrorInvalidValue;
    return tulip::launch_ln_bwd_f32(
        static_cast<const float*>(x), wf, static_cast<const float*>(g),
        static_cast<float*>(dx), p, N, C, (int)rows_per_cta, eps, s);
  }
  int cpl = 0;
  if (dtype != 1 || !gpart || !tickets || !dwdb || group <= 0 ||
      !tulip::lnr::plan_ok(N, C, lanes, rows_per_cta, ctas, cpl))
    return cudaErrorInvalidValue;
  auto gp = static_cast<float*>(gpart);
  auto t = static_cast<unsigned*>(tickets);
  auto o = static_cast<float*>(dwdb);
  TULIP_LN_CPL(bwd, x, wf, g, dx, p, gp, t, o, N, C, lanes, rows_per_cta,
               ctas, group, eps, s)
}
