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
// once (50 MB in bf16 at 131,072 x 96, 101 MB in fp32), the backward reads
// two and writes one; there are about 8 FLOPs per element.
//
// The register form (ln_fwd_reg_kernel, ln_bwd_reg_kernel), one template
// for both activation types T: rows held in registers.  A row of C values
// is C / V chunks of 16 bytes (V = 8 bf16 or 4 fp32); a group of L lanes
// takes a row, lane s of the group chunks s, s + L, s + 2L, ... (CPL
// chunks, the last masked where L does not divide C / V), so one load
// instruction of the warp reads 32 / L rows' L * 16 contiguous bytes each.
// x (and g) are read once, in 16-byte loads; the statistics come from the
// registers by shuffles inside the group (xor offsets < L); y / dx leave in
// 16-byte stores.  w and b are the same for every row a lane visits: the
// forward holds its lane's columns of them in registers, the backward reads
// w from shared memory (its registers hold the dw / db sums).  The grid is
// persistent, two CTAs an SM at up to three chunks a lane: CTA i takes the
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
// Registers at wide rows.  Up to kRegCpl (6) chunks a lane everything
// above lives in registers: bf16 at every width it takes (C <= 1,536), fp32
// up to C 768.  An fp32 row of up to 1,536 values takes 7-12 chunks a lane
// (the wide instantiations, CPL > kRegCpl, always L = 32, one row a warp):
// a lane's x, next x, g, next g and sums would be 24 registers a chunk,
// 288 at C 1,536.  There the forward reads w and b from shared memory (its
// registers hold this row and the next), and the backward adds each lane's
// dw / db into its warp's shared [dw | db] row, which the register form
// fills only at the end, and loads no row ahead (the CTA's other warps
// keep loads in flight); the order of every sum is the register form's.
//
// The any-width form (ln_fwd_row_f32_kernel, ln_bwd_row_f32_kernel), fp32
// only, takes the widths the register form does not (C % 4 != 0, or C over
// 1,536): one warp a row, lanes strided over the columns, 4-byte accesses,
// three passes over the row (L1 holds it); the backward's per-warp sums
// live in shared memory, and its CTA partials end in the same two levels of
// tickets.  ops/ln.py:ln_plan picks the form by C alone.
#include <cstdint>

#include "common.cuh"

namespace tulip {
namespace lnr {

using bf16 = __nv_bfloat16;

constexpr int kLnWarps = kThreads / 32;   // warps per CTA
constexpr int kRegCpl = 6;   // chunks a lane at most with its sums in registers

// 16-byte chunks a lane at most: C <= 1,536 in both types
template <typename T> constexpr int max_cpl() {
  return sizeof(T) == 4 ? 12 : 6;
}

// CTAs per SM each kernel is built for (a thread may take 65,536 / (256 x
// CTAs) registers); ops/ln.py:_blocks_per_sm mirrors this
template <int CPL> constexpr int blocks_per_sm() { return CPL <= 3 ? 2 : 1; }

// A 16-byte chunk of T as its V fp32 values, and back.
template <typename T> struct Chunk;

template <> struct Chunk<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& v,
                                                float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <> struct Chunk<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& v,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// the V fp32 values of chunk j of v (zeros where j is past the row's end);
// v 16-byte aligned
template <int V>
__device__ __forceinline__ void cols(const float* v, int j, int chunks,
                                     float (&o)[V]) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* v4 = reinterpret_cast<const float4*>(v) + (V / 4) * j;
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = j < chunks ? v4[q] : z;
    o[4 * q] = a.x, o[4 * q + 1] = a.y, o[4 * q + 2] = a.z;
    o[4 * q + 3] = a.w;
  }
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
template <typename T, int CPL>
__device__ __forceinline__ void load_row(uint4 (&v)[CPL],
                                         const T* __restrict__ base,
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
template <typename T, int CPL>
__device__ __forceinline__ void stats(const uint4 (&xv)[CPL], int C,
                                      int chunks, int L, int sub, float eps,
                                      float& mean, float& rstd) {
  constexpr int V = Chunk<T>::V;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    float f[V];
    Chunk<T>::unpack(xv[k], f);
#pragma unroll
    for (int i = 0; i < V; ++i) s += f[i];
  }
  mean = group_sum(s, L) / C;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    if (k * L + sub >= chunks) continue;
    float f[V];
    Chunk<T>::unpack(xv[k], f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = f[i] - mean;
      q += d * d;
    }
  }
  rstd = rsqrtf(group_sum(q, L) / C + eps);
}

// wide instantiations (CPL > kRegCpl): dynamic shared memory holds w, then
// b (2C floats)
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<CPL>())
    ln_fwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      long long N, int C, int L, long long rows_per_cta,
                      float eps) {
  using K = Chunk<T>;
  constexpr int V = K::V;
  constexpr bool kWide = CPL > kRegCpl;
  extern __shared__ float4 smem4[];
  const float* wsm = reinterpret_cast<const float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (L - 1), grp = lane / L, rows = 32 / L;
  const int chunks = C / V;
  float wr[kWide ? 1 : CPL][V], br[kWide ? 1 : CPL][V];
  if constexpr (kWide) {
    for (int c = threadIdx.x; c < C / 4; c += kThreads) {
      smem4[c] = __ldg(reinterpret_cast<const float4*>(w) + c);
      smem4[C / 4 + c] = __ldg(reinterpret_cast<const float4*>(b) + c);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      cols<V>(w, k * L + sub, chunks, wr[k]);
      cols<V>(b, k * L + sub, chunks, br[k]);
    }
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
    stats<T>(cur, C, chunks, L, sub, eps, mean, rstd);
    uint4* yr = reinterpret_cast<uint4*>(y) + r * chunks;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      float f[V], wv[V], bv[V];
      K::unpack(cur[k], f);
      if constexpr (kWide) {
        cols<V>(wsm, j, chunks, wv);
        cols<V>(wsm + C, j, chunks, bv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) wv[i] = wr[k][i], bv[i] = br[k][i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = (f[i] - mean) * rstd * wv[i] + bv[i];
      if (r < r1 && j < chunks) yr[j] = K::pack(f);
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

// After every CTA wrote its partial (row blockIdx.x of part, m4 float4):
// the last of each group of `group` CTAs adds the group's partials in CTA
// order into gpart, and the last of those adds the group sums in group
// order into dwdb; each counter is left 0 for the next launch.
__device__ __forceinline__ void finish_sums(const float4* part4,
                                            float4* gpart4,
                                            unsigned* tickets, float4* dwdb4,
                                            int m4, int group, bool& last) {
  const int P = gridDim.x, gi = blockIdx.x / group;
  const int ngroups = (P + group - 1) / group;
  const int p0 = gi * group, p1 = min(P, p0 + group);
  if (!last_ticket(tickets + 1 + gi, p1 - p0, last)) return;
  sum_rows(part4, p0, p1, m4, gpart4 + (size_t)gi * m4);
  if (threadIdx.x == 0) tickets[1 + gi] = 0u;   // ready for the next launch
  if (!last_ticket(tickets, ngroups, last)) return;
  sum_rows(gpart4, 0, ngroups, m4, dwdb4);
  if (threadIdx.x == 0) tickets[0] = 0u;
}

// part: (gridDim.x, 2C) and gpart: (ceil(gridDim.x / group), 2C) fp32
// scratch; tickets: 1 + ceil(gridDim.x / group) counters, 0 before the
// launch and left 0 after it; dwdb: (2, C), the result [dw; db]
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<CPL>())
    ln_bwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ part, float* __restrict__ gpart,
                      unsigned* __restrict__ tickets,
                      float* __restrict__ dwdb, long long N, int C, int L,
                      long long rows_per_cta, int group, float eps) {
  using K = Chunk<T>;
  constexpr int V = K::V;
  constexpr int Q = V / 4;   // float4 of a chunk's values
  constexpr bool kWide = CPL > kRegCpl;
  // w (C floats), then one [dw | db] row (2C floats) per warp
  extern __shared__ float4 smem4[];
  const float* wsm = reinterpret_cast<const float*>(smem4);
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane & (L - 1), grp = lane / L, rows = 32 / L;
  const int chunks = C / V;
  const int m4 = C / 2;   // float4 columns of a (2, C) row
  float4* slab = smem4 + C / 4 + warp * m4;
  // w from shared memory: in registers it would leave too few for two CTAs
  // an SM beside the row chunks and the dw / db sums
  for (int c = threadIdx.x; c < C / 4; c += kThreads)
    smem4[c] = __ldg(reinterpret_cast<const float4*>(w) + c);
  if constexpr (kWide) {
    for (int c = threadIdx.x; c < kLnWarps * m4; c += kThreads)
      smem4[C / 4 + c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  float dwa[kWide ? 1 : CPL][V], dba[kWide ? 1 : CPL][V];
  if constexpr (!kWide) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) dwa[k][i] = dba[k][i] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(N, r0 + rows_per_cta);
  const long long step = (long long)kLnWarps * rows;
  long long base = r0 + (long long)warp * rows;   // warp-uniform
  uint4 xc[CPL], gc[CPL];
  load_row(xc, x, base + grp, r1, chunks, L, sub);
  load_row(gc, g, base + grp, r1, chunks, L, sub);
  for (; base < r1; base += step) {
    const long long r = base + grp;
    uint4 xn[kWide ? 1 : CPL], gn[kWide ? 1 : CPL];
    if constexpr (!kWide) {
      load_row(xn, x, r + step, r1, chunks, L, sub);
      load_row(gn, g, r + step, r1, chunks, L, sub);
    }
    float mean, rstd;
    stats<T>(xc, C, chunks, L, sub, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      float xf[V], gf[V], wv[V], aw[V], ab[V];
      K::unpack(xc[k], xf);
      K::unpack(gc[k], gf);
      cols<V>(wsm, j, chunks, wv);
      if constexpr (kWide) {
        cols<V>(reinterpret_cast<const float*>(slab), j, chunks, aw);
        cols<V>(reinterpret_cast<const float*>(slab) + C, j, chunks, ab);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) aw[i] = dwa[k][i], ab[i] = dba[k][i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (xf[i] - mean) * rstd;
        const float t = gf[i] * wv[i];
        s1 += t;
        s2 += t * xh;
        aw[i] += gf[i] * xh;
        ab[i] += gf[i];
      }
      if constexpr (kWide) {
        if (j < chunks) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            slab[Q * j + q] = make_float4(aw[4 * q], aw[4 * q + 1],
                                          aw[4 * q + 2], aw[4 * q + 3]);
            slab[C / 4 + Q * j + q] = make_float4(
                ab[4 * q], ab[4 * q + 1], ab[4 * q + 2], ab[4 * q + 3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dwa[k][i] = aw[i], dba[k][i] = ab[i];
      }
    }
    group_sum2(s1, s2, L);
    const float m1 = s1 / C, m2 = s2 / C;
    uint4* dxr = reinterpret_cast<uint4*>(dx) + r * chunks;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = k * L + sub;
      float xf[V], gf[V], wv[V];
      K::unpack(xc[k], xf);
      K::unpack(gc[k], gf);
      cols<V>(wsm, j, chunks, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = (xf[i] - mean) * rstd;
        xf[i] = rstd * (gf[i] * wv[i] - m1 - xh * m2);
      }
      if (r < r1 && j < chunks) dxr[j] = K::pack(xf);
    }
    if constexpr (kWide) {
      load_row(xc, x, r + step, r1, chunks, L, sub);
      load_row(gc, g, r + step, r1, chunks, L, sub);
    } else {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        xc[k] = xn[k];
        gc[k] = gn[k];
      }
    }
  }
  if constexpr (!kWide) {
    // the warp's row groups: lanes of one column set are L apart (one
    // level of the butterfly for every sum at a time: 2 V CPL independent
    // shuffles)
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < CPL; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          dwa[k][i] += __shfl_xor_sync(0xffffffffu, dwa[k][i], o);
          dba[k][i] += __shfl_xor_sync(0xffffffffu, dba[k][i], o);
        }
    }
    // each warp writes its sums to its own [dw | db] row
    if (lane < L) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = k * L + sub;
        if (j >= chunks) continue;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          slab[Q * j + q] = make_float4(dwa[k][4 * q], dwa[k][4 * q + 1],
                                        dwa[k][4 * q + 2], dwa[k][4 * q + 3]);
          slab[C / 4 + Q * j + q] =
              make_float4(dba[k][4 * q], dba[k][4 * q + 1],
                          dba[k][4 * q + 2], dba[k][4 * q + 3]);
        }
      }
    }
  }
  __syncthreads();
  // the CTA's warps: each column adds the rows in warp order into the
  // CTA's partial; then the CTAs, in two levels of tickets
  float4* part4 = reinterpret_cast<float4*>(part);
  for (int c = threadIdx.x; c < m4; c += kThreads) {
    const float4* col = smem4 + C / 4 + c;
    float4 acc = col[0];
#pragma unroll
    for (int wp = 1; wp < kLnWarps; ++wp) add4(acc, col[wp * m4]);
    part4[(size_t)blockIdx.x * m4 + c] = acc;
  }
  finish_sums(part4, reinterpret_cast<float4*>(gpart), tickets,
              reinterpret_cast<float4*>(dwdb), m4, group, last);
}

// ---------------------------------------------------------------------------
// fp32 widths off the register plan: one warp a row

// mean and 1/std of one row, by the whole warp
__device__ __forceinline__ void row_mean_rstd(const float* __restrict__ xr,
                                              int C, int lane, float eps,
                                              float& mean, float& rstd) {
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += xr[c];
  mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mean;
    sq += d * d;
  }
  rstd = rsqrtf(warp_sum(sq) / C + eps);
}

// CTA i takes rows [i * rows_per_cta, (i + 1) * rows_per_cta), its warp w
// the rows w, w + 8, ... of that range
__global__ void __launch_bounds__(kThreads) ln_fwd_row_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, long long N, int C,
    long long rows_per_cta, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(N, r0 + rows_per_cta);
  for (long long r = r0 + warp; r < r1; r += kLnWarps) {
    const float* xr = x + r * C;
    float* yr = y + r * C;
    float mean, rstd;
    row_mean_rstd(xr, C, lane, eps, mean, rstd);
    for (int c = lane; c < C; c += 32)
      yr[c] = (xr[c] - mean) * rstd * w[c] + b[c];
  }
}

// part: (gridDim.x, 4 m4) with m4 = ceil(2C / 4), [dw | db] and zeros to
// the row's end; gpart, tickets and dwdb (4 m4 floats) as in
// ln_bwd_reg_kernel
__global__ void __launch_bounds__(kThreads) ln_bwd_row_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ part, float* __restrict__ gpart,
    unsigned* __restrict__ tickets, float* __restrict__ dwdb, long long N,
    int C, long long rows_per_cta, int group, float eps) {
  extern __shared__ float4 smem4[];   // [kLnWarps][2C]: each warp's sums
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dw = smem + (size_t)warp * 2 * C;
  float* db = dw + C;
  for (int c = lane; c < C; c += 32) {
    dw[c] = 0.f;
    db[c] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = min(N, r0 + rows_per_cta);
  for (long long r = r0 + warp; r < r1; r += kLnWarps) {
    const float* xr = x + r * C;
    const float* gr = g + r * C;
    float* dxr = dx + r * C;
    float mean, rstd;
    row_mean_rstd(xr, C, lane, eps, mean, rstd);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = gr[c];
      const float xh = (xr[c] - mean) * rstd;
      const float t = gv * w[c];
      s1 += t;
      s2 += t * xh;
      dw[c] += gv * xh;
      db[c] += gv;
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (xr[c] - mean) * rstd;
      dxr[c] = rstd * (gr[c] * w[c] - m1 - xh * m2);
    }
  }
  __syncthreads();
  const int m4 = (2 * C + 3) / 4;
  float* out = part + (size_t)blockIdx.x * 4 * m4;
  for (int i = threadIdx.x; i < 4 * m4; i += kThreads) {
    float t = 0.f;
    if (i < 2 * C) {
      for (int wp = 0; wp < kLnWarps; ++wp) t += smem[(size_t)wp * 2 * C + i];
    }
    out[i] = t;
  }
  finish_sums(reinterpret_cast<const float4*>(part),
              reinterpret_cast<float4*>(gpart), tickets,
              reinterpret_cast<float4*>(dwdb), m4, group, last);
}

// ---------------------------------------------------------------------------
// launches

// the register form takes C (as ops/ln.py:ln_plan): whole 16-byte chunks,
// at most max_cpl a lane of 32
template <typename T> inline bool reg_width(int C) {
  constexpr int V = Chunk<T>::V;
  return C > 0 && C % V == 0 && C / V <= 32 * max_cpl<T>();
}

// CTA i takes rows [i rows_per_cta, (i + 1) rows_per_cta): every row once,
// every CTA some
inline bool grid_ok(long long N, long long rows_per_cta, int ctas) {
  return N > 0 && ctas > 0 && rows_per_cta > 0 &&
         (long long)ctas * rows_per_cta >= N &&
         (long long)(ctas - 1) * rows_per_cta < N;
}

// the register plan's invariants (ops/ln.py:ln_plan); false where it is
// not one
template <typename T>
inline bool plan_ok(long long N, int C, int L, long long rows_per_cta,
                    int ctas, int& cpl) {
  if (!reg_width<T>(C) || L <= 0 || L > 32 || (L & (L - 1)) ||
      !grid_ok(N, rows_per_cta, ctas) || rows_per_cta % (32 / L))
    return false;
  cpl = (C / Chunk<T>::V + L - 1) / L;
  return cpl <= max_cpl<T>();
}

template <typename T, int CPL>
cudaError_t fwd(const void* x, const float* w, const float* b, void* y,
                long long N, int C, int L, long long rows_per_cta, int ctas,
                float eps, cudaStream_t stream) {
  if constexpr (CPL > max_cpl<T>()) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = CPL > kRegCpl ? sizeof(float) * 2 * C : 0;
    ln_fwd_reg_kernel<T, CPL><<<ctas, kThreads, smem, stream>>>(
        static_cast<const T*>(x), w, b, static_cast<T*>(y), N, C, L,
        rows_per_cta, eps);
    return cudaGetLastError();
  }
}

template <typename T, int CPL>
cudaError_t bwd(const void* x, const float* w, const void* g, void* dx,
                float* part, float* gpart, unsigned* tickets, float* dwdb,
                long long N, int C, int L, long long rows_per_cta, int ctas,
                int group, float eps, cudaStream_t stream) {
  if constexpr (CPL > max_cpl<T>()) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = sizeof(float) * (1 + 2 * kLnWarps) * C;
    if (smem > 48 * 1024) {
      cudaError_t err = prepare_smem(ln_bwd_reg_kernel<T, CPL>, smem);
      if (err != cudaSuccess) return err;
    }
    ln_bwd_reg_kernel<T, CPL><<<ctas, kThreads, smem, stream>>>(
        static_cast<const T*>(x), w, static_cast<const T*>(g),
        static_cast<T*>(dx), part, gpart, tickets, dwdb, N, C, L,
        rows_per_cta, group, eps);
    return cudaGetLastError();
  }
}

// F<T, cpl>(...) for cpl 1 .. 12
#define TULIP_LN_CPL(F, T, ...)                           \
  switch (cpl) {                                          \
    case 1: return F<T, 1>(__VA_ARGS__);                  \
    case 2: return F<T, 2>(__VA_ARGS__);                  \
    case 3: return F<T, 3>(__VA_ARGS__);                  \
    case 4: return F<T, 4>(__VA_ARGS__);                  \
    case 5: return F<T, 5>(__VA_ARGS__);                  \
    case 6: return F<T, 6>(__VA_ARGS__);                  \
    case 7: return F<T, 7>(__VA_ARGS__);                  \
    case 8: return F<T, 8>(__VA_ARGS__);                  \
    case 9: return F<T, 9>(__VA_ARGS__);                  \
    case 10: return F<T, 10>(__VA_ARGS__);                \
    case 11: return F<T, 11>(__VA_ARGS__);                \
    case 12: return F<T, 12>(__VA_ARGS__);                \
    default: return cudaErrorInvalidValue;                \
  }

template <typename T>
cudaError_t fwd_reg(const void* x, const float* w, const float* b, void* y,
                    long long N, int C, int L, long long rows_per_cta,
                    int ctas, float eps, cudaStream_t stream) {
  int cpl = 0;
  if (!plan_ok<T>(N, C, L, rows_per_cta, ctas, cpl))
    return cudaErrorInvalidValue;
  TULIP_LN_CPL(fwd, T, x, w, b, y, N, C, L, rows_per_cta, ctas, eps, stream)
}

template <typename T>
cudaError_t bwd_reg(const void* x, const float* w, const void* g, void* dx,
                    float* part, float* gpart, unsigned* tickets,
                    float* dwdb, long long N, int C, int L,
                    long long rows_per_cta, int ctas, int group, float eps,
                    cudaStream_t stream) {
  int cpl = 0;
  if (!plan_ok<T>(N, C, L, rows_per_cta, ctas, cpl))
    return cudaErrorInvalidValue;
  TULIP_LN_CPL(bwd, T, x, w, g, dx, part, gpart, tickets, dwdb, N, C, L,
               rows_per_cta, ctas, group, eps, stream)
}

}  // namespace lnr
}  // namespace tulip

// dtype of x, y, g and dx: 0 fp32, 1 bf16; w, b, part, gpart and dwdb are
// fp32, 16-byte aligned (w and b are read in 16-byte pieces), as are x,
// y, g and dx where the register form runs.  The form follows C (as
// ops/ln.py:ln_plan): the register form where C is whole 16-byte chunks,
// at most 12 (fp32) or 6 (bf16) a lane of 32; else fp32 takes the
// any-width form (lanes 32) and bf16 is refused.  Both check the plan
// (lanes per row, rows per CTA, CTAs, CTAs per group of the backward's
// sum) and refuse one that breaks its invariants.
extern "C" int tulip_ln_fwd(int dtype, const void* x, const void* w,
                            const void* b, void* y, long long N, int C,
                            int lanes, long long rows_per_cta, int ctas,
                            float eps, void* stream) {
  using namespace tulip::lnr;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(b);
  if (dtype == 1)
    return fwd_reg<bf16>(x, wf, bf, y, N, C, lanes, rows_per_cta, ctas, eps,
                         s);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (reg_width<float>(C))
    return fwd_reg<float>(x, wf, bf, y, N, C, lanes, rows_per_cta, ctas,
                          eps, s);
  if (C <= 0 || lanes != 32 || !grid_ok(N, rows_per_cta, ctas))
    return cudaErrorInvalidValue;
  ln_fwd_row_f32_kernel<<<ctas, tulip::kThreads, 0, s>>>(
      static_cast<const float*>(x), wf, bf, static_cast<float*>(y), N, C,
      rows_per_cta, eps);
  return cudaGetLastError();
}

// part (ctas, S) and gpart (ceil(ctas / group), S) scratch with S = 2C
// rounded up to a multiple of 4, tickets 1 + ceil(ctas / group) device
// counters that are 0 before the launch and after it, dwdb (S) the result
// [dw; db] (and zeros past 2C).
extern "C" int tulip_ln_bwd(int dtype, const void* x, const void* w,
                            const void* g, void* dx, void* part, void* gpart,
                            void* tickets, void* dwdb, long long N, int C,
                            int lanes, long long rows_per_cta, int ctas,
                            int group, float eps, void* stream) {
  using namespace tulip::lnr;
  auto s = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto p = static_cast<float*>(part);
  auto gp = static_cast<float*>(gpart);
  auto t = static_cast<unsigned*>(tickets);
  auto o = static_cast<float*>(dwdb);
  if (!p || !gp || !t || !o || group <= 0) return cudaErrorInvalidValue;
  if (dtype == 1)
    return bwd_reg<bf16>(x, wf, g, dx, p, gp, t, o, N, C, lanes,
                         rows_per_cta, ctas, group, eps, s);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (reg_width<float>(C))
    return bwd_reg<float>(x, wf, g, dx, p, gp, t, o, N, C, lanes,
                          rows_per_cta, ctas, group, eps, s);
  if (C <= 0 || lanes != 32 || !grid_ok(N, rows_per_cta, ctas))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * kLnWarps * (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t err = tulip::prepare_smem(ln_bwd_row_f32_kernel, smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_row_f32_kernel<<<ctas, tulip::kThreads, smem, s>>>(
      static_cast<const float*>(x), wf, static_cast<const float*>(g),
      static_cast<float*>(dx), p, gp, t, o, N, C, rows_per_cta, group, eps);
  return cudaGetLastError();
}
