// Exact nearest-neighbour squared distances for the chamfer metric.
//
// tulip_nn_brute replaces tulip_tpu/ops/pallas/chamfer.py:_kernel (K7):
//   out[i] = min_j |a_i - b_j|^2 over every target point.
// tulip_nn_h2 replaces chamfer_h.py:_kernel_h2 (K5): both directions, over
//   a list of tile pairs built on the device in rounds of tighter bounds,
//   swept by a persistent grid (section "K5" below).
// tulip_nn_h1 replaces chamfer_h.py:_kernel_h (K6): K7's minimum, exact, as
//   the one-direction mode of K5's machinery (the same plan; rows only in
//   the bounds, the rounds and the sweep).
//
// Numerics: the direct form dx*dx + dy*dy + dz*dz in fp32 (sq_dist below).
// It cannot go negative and does not cancel, unlike the TPU's augmented
// |b|^2 - 2a.b + |a|^2 contraction, which loses ~1e-3 m^2 per pair at 120 m.
// All three kernels use the same sq_dist, so K5 and K6 return K7's values.
//
// K7's bound on the H100: the fp32 issue rate.  Brute force at 262,144 x
// 262,144 points is 6.9e10 pairs of 7 fp32 instructions (3 sub, mul, 2 fma,
// min): 14.36 ms at 33.5e12 instructions/s; the inputs are 3 MB each and
// stay in L2.  Design: one block of 128 threads per 512-query tile (each
// thread keeps 4 queries and their running minima in registers: 512 blocks
// at 262k points, ~3.9 per SM); the block stages one target chunk at a time
// in shared memory as three coordinate arrays that every thread reads by
// broadcast.  Tensor cores are not used: the fp32 minimum of a 3-term sum is
// CUDA-core work.  Measured on an H100 80GB HBM3 at 700 W, a synthetic
// DurLAR scan against a perturbed copy (262,144 points each): 20.9 ms.
//
// Ragged query counts are masked in the kernel: a query row >= N sits at
// +inf, starts at a minimum of 0 and is not stored.
#include <cuda_runtime.h>

#include "common.cuh"

namespace tulip {
namespace nn {

constexpr int kThreads = 128;
constexpr int kQ = 4;                    // queries per thread
constexpr int kTile = kThreads * kQ;     // query rows per block
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

// Shared launch checks: N, M > 0, TM a positive multiple of 32 dividing M,
// and the staged chunk within the block's shared memory.
inline bool shapes_ok(int N, int M, int TM) {
  return N > 0 && M > 0 && TM > 0 && TM % 32 == 0 && M % TM == 0;
}


// ---------------------------------------------------------------------------
// K5: both directions over a list of tile pairs built on the device; K6:
// the same machinery in one direction (kBoth = false below).
//
// Plan (tulip_nn_h2_codes, a stable argsort in the wrapper, then
// tulip_nn_h2_gather): the joint box of both clouds' real points (not 1e8
// sentinels), 10-bit-per-axis Morton codes over it (b's tagged with bit 30,
// so that one argsort orders both clouds), the sorted clouds and the boxes
// (center, half-extent) of their tiles: kRows = 128 Morton-consecutive
// points of a (4 per lane of a warp), kCols = 32 of b (1 per lane).  The
// same arithmetic as ops/chamfer.py:h2_plan, which phase 3 of chip_smoke.py
// holds it to.  box_lb is the squared AABB lower bound of chamfer_h.py
// (1e-3 m of slack before squaring).  A tile that mixes real points with
// sentinels spans ~5e7 m, where fp32 rounds its edges by up to 8 m, far
// beyond the slack, so that its bound could exceed true distances: such a
// tile (a half-extent above kWide) gets an infinite half-extent, which
// bounds it by 0 against every tile.  Sentinels sort last, so a cloud has
// at most one such tile.
//
// The TPU kernel walked every target chunk for every query tile and tested
// its skip rule at each step.  Here the pairs to evaluate are listed first,
// in kRounds rounds, and a persistent grid sweeps each round's list:
//
//   round 0  (i, j) with lb == min_j' lb(i, j') or lb == min_i' lb(i', j):
//            every tile's nearest tiles by bound (all ties: every
//            overlapping tile where boxes overlap), so that every row and
//            column gets a true partial minimum;
//   round r  (i, j) of no earlier round with lb < f_r ub_a[i] or
//            lb < f_r ub_b[j], f = 1/64, 1/8, 1, where ub_a / ub_b are the
//            tiles' largest current minima (nn2_ub_kernel).
//
// Both tests run as box_gap2 < a threshold per tile (s_threshold), which
// selects the same pairs as the tests on lb without a square root.
//
// Exact: a pair of no round has lb >= ub_a[i] and lb >= ub_b[j] as read
// before the last round; the minima only fall, so every distance of the
// pair is >= lb >= each final minimum of its rows and columns and could
// lower none.  Minima are combined with atomicMin on the float bits, which
// orders non-negative floats as their values, so the result is K7's, bit
// for bit, in any order of the list.  The rounds with f < 1 only tighten the
// bounds before the last one: on the eval clouds two rounds (first, then
// f = 1) evaluate 3.3-6.9 % of all pairs where 2.0-2.1 % are needed, these
// four 2.1 %; on a scan and a perturbed copy 0.45 % against 0.44 %.
//
// K6 (kBoth = false) keeps the row halves of every step: round 0 lists each
// pair at its row's smallest bound (all ties), so every query gets a true
// partial minimum; round r lists each pair of no earlier round with lb <
// f_r ub_a[i].  Exact: a pair of no round has lb >= ub_a[i] as read before
// the last round, and ub_a[i] >= every final minimum of row tile i, so none
// of its distances could lower one; row minima reach sa by atomicMin on the
// float bits, so the result is K7's in any list order.  Column minima are
// never needed, so the sweep drops them: 7 instructions a pair.
//
// Bound on the H100: the sweep's fp32 issue rate (8 instructions per pair
// evaluated in both directions, 7 in one); the plan is a few passes over (N
// + M) points and over the Ti x Tj = 16.8M tile pairs of two 262,144-point
// clouds.  The kernels, in launch order: nn2_box_kernel and
// nn2_morton_kernel (codes), the argsort, nn2_gather_kernel;
// nn2_bound_kernel (every pair's squared gap once per direction: round 0's
// thresholds, and each row's smallest gap per word of 32 target tiles); then
// per round nn2_ub_kernel (rounds 1-3, a warp per tile), nn2_list_kernel (a
// warp per row and 32 words, which passes over every word whose smallest gap
// fails both thresholds and evaluates the rest a lane per target tile,
// against the bitmap `done` of earlier rounds; one atomicAdd per warp for
// its place in the list) and the sweep; last nn2_unsort_kernel (sa / sb back
// to the callers' order).  The pair counts stay on the device: the sweep's
// grid is fixed (SMs x blocks per SM) and its warps take kItem entries at a
// time from an atomic counter until the list ends.
// nn2_sweep_kernel: a warp holds its query tile's 128 points (12 registers
// a lane) and their row minima in registers while it walks consecutive
// entries of one row; the target tile comes in as one point per lane,
// prefetched one entry ahead, and is read back by broadcast from shared
// memory.  In K5 a lane's 32 column minima over its 4 queries are reduced
// across the warp by a reduce-scatter (31 shuffles), after which lane l
// holds column l and lowers sb with one atomicMin; row minima go to sa when
// the warp moves to another row.  K5: 8 instructions per pair (3 sub, mul,
// 2 fma, 2 min) and about 1.2 per pair of overhead; K6: 7 and no
// reduce-scatter.
namespace h2 {

constexpr int kRows = 128;
constexpr int kQL = kRows / 32;          // queries per lane
constexpr int kCols = 32;
constexpr int kBlockWarps = 8;
constexpr int kBlock = 32 * kBlockWarps;
constexpr int kStage = 1024;             // column tiles per staging step
constexpr int kItem = 4;                 // list entries a warp takes at once
constexpr int kRounds = 4;
constexpr int kBoxBlocks = 264;          // blocks of the box and code kernels
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();
constexpr float kWide = 1e6f;            // m: a tile this wide holds a sentinel

// The squared lower bound on |p - q| for p in box 1, q in box 2 (centers
// c, half-extents h) is lb_of(box_gap2(...)), in the order of
// ops/chamfer.py:box_lb_table: s, the squared norm of the per-axis gaps,
// then (sqrt(s) - 1e-3 m)^2, floored at 0.  Rounded operations only, so
// that every kernel computes the same bits for a pair; box 1 is always the
// query tile's.  lb_of is monotone in s, so the hot loops compare s with
// s_threshold(T) instead of lb with T and never take a square root.
__device__ __forceinline__ float box_gap2(const float* c1, const float* h1,
                                          const float* c2, const float* h2) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float g = __fsub_rn(__fsub_rn(fabsf(__fsub_rn(c1[k], c2[k])), h1[k]),
                        h2[k]);
    g = fmaxf(g, 0.f);
    s = __fadd_rn(s, __fmul_rn(g, g));
  }
  return s;
}

__device__ __forceinline__ float lb_of(float s) {
  const float l = fmaxf(__fsub_rn(__fsqrt_rn(s), 1e-3f), 0.f);
  return __fmul_rn(l, l);
}

// The least s >= 0 with lb_of(s) >= T (0 for T <= 0): for s >= 0,
// lb_of(s) < T exactly when s < s_threshold(T).  A search over the bits of
// s (non-negative floats order as their bits) by the whole warp, T the
// same in every lane: each step probes 32 points of [lo, hi] and keeps the
// step between the last probe below T and the first at or above it (lb_of
// is monotone, so the ballot is a run of ones from that lane up); seven
// steps instead of 31 halvings.
__device__ __forceinline__ float s_threshold(float T, int lane) {
  if (!(T > 0.f)) return 0.f;
  unsigned lo = 0u, hi = 0x7f800000u;          // lb_of(lo) < T <= lb_of(hi)
  while (hi - lo > 1u) {
    const unsigned step = (hi - lo + 31u) / 32u;
    const unsigned probe = min(lo + step * (lane + 1), hi);
    const bool ge = probe == hi || lb_of(__uint_as_float(probe)) >= T;
    const int f = __ffs(__ballot_sync(kFull, ge)) - 1;
    const unsigned next_hi = min(lo + step * (f + 1), hi);
    lo = lo + step * f;
    hi = next_hi;
  }
  return __uint_as_float(hi);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 10 bits spread to every third bit (chamfer_h.py:_morton10's part1by2)
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

// Point r of the joint cloud: a's N points, then b's M.
__device__ __forceinline__ const float* joint(const float* a, const float* b,
                                              long long r, int N) {
  return r < N ? a + 3 * r : b + 3 * (r - N);
}

// partial[6 * block + k]: the min (k < 3) and max (k >= 3) per axis over
// this block's share of the points of a and b that are not sentinels.
__global__ void __launch_bounds__(kBlock) nn2_box_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ partial, int N, int M) {
  __shared__ float red[kBlockWarps][6];
  float v[6] = {kInf, kInf, kInf, -kInf, -kInf, -kInf};
  for (long long r = (long long)blockIdx.x * kBlock + threadIdx.x;
       r < (long long)N + M; r += (long long)gridDim.x * kBlock) {
    const float* p = joint(a, b, r, N);
    const float x = p[0], y = p[1], z = p[2];
    if (fabsf(x) < 1e7f && fabsf(y) < 1e7f && fabsf(z) < 1e7f) {
      v[0] = fminf(v[0], x); v[1] = fminf(v[1], y); v[2] = fminf(v[2], z);
      v[3] = fmaxf(v[3], x); v[4] = fmaxf(v[4], y); v[5] = fmaxf(v[5], z);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float w = k < 3 ? warp_min(v[k]) : warp_max(v[k]);
    if (lane == 0) red[warp][k] = w;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float w = red[0][k];
    for (int i = 1; i < kBlockWarps; ++i)
      w = k < 3 ? fminf(w, red[i][k]) : fmaxf(w, red[i][k]);
    partial[6 * blockIdx.x + k] = w;
  }
}

// codes[r] = the Morton code of joint point r over the joint box of the
// partials (chamfer.py:_morton_order), | 1 << 30 for b's points.
__global__ void __launch_bounds__(kBlock) nn2_morton_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ partial, int* __restrict__ codes, int N,
    int M) {
  __shared__ float box[6];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float w = k < 3 ? kInf : -kInf;
      for (int i = lane; i < kBoxBlocks; i += 32) {
        const float v = partial[6 * i + k];
        w = k < 3 ? fminf(w, v) : fmaxf(w, v);
      }
      w = k < 3 ? warp_min(w) : warp_max(w);
      if (lane == 0) box[k] = w;
    }
  }
  __syncthreads();
  float lo[3], span[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = box[k];
    span[k] = fmaxf(__fsub_rn(box[3 + k], lo[k]), 1e-6f);
  }
  for (long long r = (long long)blockIdx.x * kBlock + threadIdx.x;
       r < (long long)N + M; r += (long long)gridDim.x * kBlock) {
    const float* p = joint(a, b, r, N);
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float q = fminf(fmaxf(__fmul_rn(__fdiv_rn(__fsub_rn(p[k], lo[k]),
                                                      span[k]), 1023.f),
                                  0.f), 1023.f);
      c |= spread3((unsigned)q) << k;
    }
    codes[r] = (int)(r < N ? c : c | (1u << 30));
  }
}

// a_s / b_s: a and b in the argsort's order perm (a's N entries, then b's
// M, offset by N); boxes: ca (Ti x 3), ha, cb (Tj x 3), hb of their tiles,
// 0.5 (lo + hi) and 0.5 (hi - lo) over each tile's points (a ragged last
// query tile over its real rows; ha / hb infinite where a half-extent
// exceeds kWide).  A warp per tile.
__global__ void __launch_bounds__(kBlock) nn2_gather_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const long long* __restrict__ perm, float* __restrict__ a_s,
    float* __restrict__ b_s, float* __restrict__ boxes, int N, int Ti,
    int Tj) {
  const int tile = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (tile >= Ti + Tj) return;                           // the whole warp
  float lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
  const bool query = tile < Ti;
  const int per_lane = query ? kQL : 1;
  for (int q = 0; q < per_lane; ++q) {
    const long long r = query ? (long long)tile * kRows + q * 32 + lane
                              : (long long)(tile - Ti) * kCols + lane;
    if (query && r >= N) continue;
    const long long src = query ? perm[r] : perm[N + r] - N;
    const float* p = (query ? a : b) + 3 * src;
    float* d = (query ? a_s : b_s) + 3 * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = p[k];
      d[k] = v;
      lo[k] = fminf(lo[k], v);
      hi[k] = fmaxf(hi[k], v);
    }
  }
  float* c = query ? boxes + 3LL * tile
                   : boxes + 6LL * Ti + 3LL * (tile - Ti);
  float* h = c + 3LL * (query ? Ti : Tj);
  float bc[3], bh[3];
  bool wide = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float l = warp_min(lo[k]), u = warp_max(hi[k]);
    bc[k] = __fmul_rn(0.5f, __fadd_rn(l, u));
    bh[k] = __fmul_rn(0.5f, __fsub_rn(u, l));
    wide |= bh[k] > kWide;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = bc[k];
      h[k] = wide ? kInf : bh[k];            // a zero bound (see above)
    }
  }
}

// Stage column boxes [s0, s0 + n) of (c, h) as six coordinate arrays of
// kStage + 32 floats, column t at t + t / 32: lane l of a warp then reads
// columns 32 l + c (its own word) without bank conflicts.  Every load of a
// thread is issued before its first store, so that a stage waits on L2
// once.
constexpr int kPad = kStage + kStage / 32;
__device__ __forceinline__ void stage_boxes(const float* __restrict__ c,
                                            const float* __restrict__ h,
                                            int s0, int n, float* s_box) {
  constexpr int kPer = 3 * kStage / kBlock;
  float rc[kPer], rh[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int t = threadIdx.x + u * kBlock;
    rc[u] = t < 3 * n ? c[3LL * s0 + t] : 0.f;
    rh[u] = t < 3 * n ? h[3LL * s0 + t] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int t = threadIdx.x + u * kBlock;
    const int col = t / 3, k = t % 3;
    if (t < 3 * n) {
      s_box[k * kPad + col + col / 32] = rc[u];
      s_box[(3 + k) * kPad + col + col / 32] = rh[u];
    }
  }
}

// Fills sa, sb with kInit and zeroes the counters; then, with s =
// box_gap2, round 0's thresholds: with L the smallest bound of query tile i
// over all target tiles (blockIdx.y 0, a warp per query tile), thr_a[i] =
// s_threshold(the float above L), so that lb(i, j) == L exactly when
// s(i, j) < thr_a[i]; thr_b[j] likewise over the query tiles (blockIdx.y
// 1), and wmax[w] = the largest thr_b of word w (32 target tiles), by
// atomicMax on the bits (wmax zeroed before it).  The smallest lb is lb_of
// of the smallest s (lb_of is monotone).  blockIdx.y 0 also writes
// smin[i][w], the smallest s of row i over word w, which lets the list
// kernel pass over words that cannot hold a pair of any round.  A lane
// takes one word of each staged 1,024 columns.  One direction (K6): sa,
// the counters, thr_a and smin only, on one grid row.
template <bool kBoth>
__global__ void __launch_bounds__(kBlock) nn2_bound_kernel(
    const float* __restrict__ ca, const float* __restrict__ ha,
    const float* __restrict__ cb, const float* __restrict__ hb,
    float* __restrict__ thr_a, float* __restrict__ thr_b,
    float* __restrict__ wmax, float* __restrict__ smin,
    float* __restrict__ sa, float* __restrict__ sb,
    int* __restrict__ counters, int N, int M, int Ti, int Tj, int W) {
  __shared__ float s_box[6 * kPad];
  const long long gid =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kBlock + threadIdx.x;
  const long long gsz = (long long)gridDim.x * gridDim.y * kBlock;
  for (long long r = gid; r < N; r += gsz) sa[r] = kInit;
  if constexpr (kBoth)
    for (long long r = gid; r < M; r += gsz) sb[r] = kInit;
  if (gid < 2 * kRounds) counters[gid] = 0;
  const int dir = kBoth ? blockIdx.y : 0;
  const int R = dir ? Tj : Ti, Cn = dir ? Ti : Tj;
  if (blockIdx.x * kBlockWarps >= R) return;             // the whole block
  const float* rc = dir ? cb : ca;
  const float* rh = dir ? hb : ha;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBlockWarps + (threadIdx.x >> 5);
  const bool live = row < R;
  float mc[3], mh[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mc[k] = live ? rc[3LL * row + k] : 0.f;
    mh[k] = live ? rh[3LL * row + k] : 0.f;
  }
  float m = kInf;
  for (int s0 = 0; s0 < Cn; s0 += kStage) {
    const int n = min(kStage, Cn - s0);
    __syncthreads();
    stage_boxes(dir ? ca : cb, dir ? ha : hb, s0, n, s_box);
    __syncthreads();
    if (!live) continue;
    float wm = kInf;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int t = lane * 32 + c;
      if (t < n) {
        const int at = t + lane;                         // t + t / 32
        const float o[6] = {s_box[at], s_box[kPad + at],
                            s_box[2 * kPad + at], s_box[3 * kPad + at],
                            s_box[4 * kPad + at], s_box[5 * kPad + at]};
        wm = fminf(wm, dir ? box_gap2(o, o + 3, mc, mh)
                           : box_gap2(mc, mh, o, o + 3));
      }
    }
    m = fminf(m, wm);
    if (!dir && lane * 32 < n)
      smin[(long long)row * W + s0 / 32 + lane] = wm;
  }
  if (!live) return;
  const float t = s_threshold(nextafterf(lb_of(warp_min(m)), kInf), lane);
  if (lane == 0) {
    if (dir) {
      thr_b[row] = t;
      atomicMax(reinterpret_cast<int*>(wmax) + row / 32, __float_as_int(t));
    } else {
      thr_a[row] = t;
    }
  }
}

// The pairs of round `round` (see above): those of no earlier round (the
// bitmap done; round 0 writes it afresh) with s < thr_a[i] or s <
// thr_b[j], appended to list as i * Tj + j; done marks them.  Grid (Ti,
// ceil(W / 256)): a warp per row and segment of 32 words (1,024 target
// tiles).  A lane per word decides whether the word can hold a pair (smin
// < thr_a or smin < wmax: otherwise every s of the word fails both tests);
// the warp then evaluates such words four at a time, a lane per target
// tile, and appends the segment's pairs at the place one atomicAdd on
// *count gives it, so that they are contiguous.  One direction (K6): the
// row tests alone (s < thr_a); thr_b and wmax are not read.
template <bool kBoth>
__global__ void __launch_bounds__(kBlock) nn2_list_kernel(
    const float* __restrict__ ca, const float* __restrict__ ha,
    const float* __restrict__ cb, const float* __restrict__ hb,
    const float* __restrict__ thr_a, const float* __restrict__ thr_b,
    const float* __restrict__ wmax, const float* __restrict__ smin,
    unsigned* __restrict__ done, int* __restrict__ list,
    int* __restrict__ count, int round, int Ti, int Tj, int W) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const int w0 = (blockIdx.y * kBlockWarps + (threadIdx.x >> 5)) * 32;
  if (w0 >= W) return;                                   // the whole warp
  float mc[3], mh[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mc[k] = ca[3LL * row + k];
    mh[k] = ha[3LL * row + k];
  }
  const float rt = thr_a[row];
  const long long rw = (long long)row * W;
  const int w = w0 + lane;
  const bool in = w < W;
  const float sm = in ? smin[rw + w] : kInf;
  const unsigned old = (round && in) ? done[rw + w] : 0u;
  unsigned todo =
      __ballot_sync(kFull, in && (sm < rt || (kBoth && sm < wmax[w])));
  unsigned mine_sel = 0u;
  int total = 0;
  while (todo) {
    int k[4];
    bool p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {                        // 4 words in flight
      k[u] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1u;
      const int j = (w0 + k[u]) * 32 + lane;
      p[u] = false;
      if (k[u] >= 0 && j < Tj) {
        const float g = box_gap2(mc, mh, cb + 3LL * j, hb + 3LL * j);
        p[u] = g < rt || (kBoth && g < thr_b[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (k[u] < 0) break;                               // uniform
      const unsigned m =
          __ballot_sync(kFull, p[u]) & ~__shfl_sync(kFull, old, k[u]);
      total += __popc(m);
      if (lane == k[u]) mine_sel = m;
    }
  }
  if (in && (!round || mine_sel)) done[rw + w] = old | mine_sel;
  if (total == 0) return;                                // uniform
  int base = 0;
  if (lane == 0) base = atomicAdd(count, total);
  base = __shfl_sync(kFull, base, 0);
  unsigned nz = __ballot_sync(kFull, mine_sel != 0u);
  while (nz) {
    const int k = __ffs(nz) - 1;
    nz &= nz - 1u;
    const unsigned m = __shfl_sync(kFull, mine_sel, k);
    if ((m >> lane) & 1u)
      list[base + __popc(m & ((1u << lane) - 1u))] =
          row * Tj + (w0 + k) * 32 + lane;
    base += __popc(m);
  }
}

// A later round's thresholds: with ub the largest current minimum of query
// tile i (its real rows), thr_a[i] = s_threshold(frac ub), so that
// lb(i, j) < frac ub exactly when s(i, j) < thr_a[i]; thr_b[j] likewise for
// target tile j, and wmax[w] the largest thr_b of word w, by atomicMax on
// the bits (wmax zeroed before it).  A warp per tile: query tiles first,
// then target tiles (one direction, K6: the query tiles alone).
template <bool kBoth>
__global__ void __launch_bounds__(kBlock) nn2_ub_kernel(
    const float* __restrict__ sa, const float* __restrict__ sb,
    float* __restrict__ thr_a, float* __restrict__ thr_b,
    float* __restrict__ wmax, float frac, int N, int Ti, int Tj) {
  const int tile = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (tile >= (kBoth ? Ti + Tj : Ti)) return;           // the whole warp
  float m = 0.f;
  if (!kBoth || tile < Ti) {
#pragma unroll
    for (int q = 0; q < kQL; ++q) {
      const long long r = (long long)tile * kRows + q * 32 + lane;
      if (r < N) m = fmaxf(m, __ldcg(sa + r));
    }
  } else {
    m = __ldcg(sb + (long long)(tile - Ti) * kCols + lane);
  }
  const float t = s_threshold(frac * warp_max(m), lane);
  if (lane == 0) {
    if (!kBoth || tile < Ti) {
      thr_a[tile] = t;
    } else {
      thr_b[tile - Ti] = t;
      atomicMax(reinterpret_cast<int*>(wmax) + (tile - Ti) / 32,
                __float_as_int(t));
    }
  }
}

// After it, lane l holds the minimum over the warp of v[l]: at each step a
// lane keeps the half of its values whose index has its lane bit, and takes
// the minimum with its partner's copy of that half.  Every index is a
// constant (one template step per bit) and the halves are chosen by bit
// masks, so v stays in registers.
template <int S>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[kCols],
                                                    int lane) {
  const int up = (lane & S) ? -1 : 0;                    // all ones: upper
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int lo = __float_as_int(v[k]), hi = __float_as_int(v[k + S]);
    const float send = __int_as_float((lo & up) | (hi & ~up));
    const float keep = __int_as_float((hi & up) | (lo & ~up));
    v[k] = fminf(keep, __shfl_xor_sync(kFull, send, S));
  }
}

__device__ __forceinline__ float reduce_scatter_min(float (&v)[kCols],
                                                   int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ float4 load_target(const float* b, int j,
                                              int lane) {
  const float* p = b + 3 * ((long long)j * kCols + lane);
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
}

// The sweep over one round's list (count = cn[0], next-item counter cn[1]);
// row minima to sa and, in both directions (K5), column minima to sb.
template <bool kBoth>
__device__ __forceinline__ void sweep_list(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ list, int* cn, float* sa, float* sb, int N,
    int Tj) {
  __shared__ float4 slab[kBlockWarps][kCols];
  const int lane = threadIdx.x & 31;
  float4* my = slab[threadIdx.x >> 5];
  const int count = __ldcg(cn);
  int cur = -1;
  float qx[kQL], qy[kQL], qz[kQL], best[kQL];
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(cn + 1, 1);
    const int e0 = __shfl_sync(kFull, item, 0) * kItem;
    if (e0 >= count) break;
    const int e1 = min(e0 + kItem, count);
    int ent = __ldcg(list + e0);
    float4 p = load_target(b, ent % Tj, lane);
    for (int e = e0; e < e1; ++e) {
      const int i = ent / Tj, j = ent - i * Tj;
      (void)j;                               // one direction: unused
      const float4 t = p;
      if (e + 1 < e1) {                                  // one entry ahead
        ent = __ldcg(list + e + 1);
        p = load_target(b, ent % Tj, lane);
      }
      if (i != cur) {
#pragma unroll
        for (int q = 0; q < kQL; ++q) {
          const long long r = (long long)cur * kRows + q * 32 + lane;
          if (cur >= 0 && r < N)
            atomicMin(reinterpret_cast<int*>(sa) + r,
                      __float_as_int(best[q]));
          const long long r2 = (long long)i * kRows + q * 32 + lane;
          const bool real = r2 < N;
          qx[q] = real ? a[3 * r2] : kInf;
          qy[q] = real ? a[3 * r2 + 1] : kInf;
          qz[q] = real ? a[3 * r2 + 2] : kInf;
          best[q] = kInit;
        }
        cur = i;
      }
      __syncwarp();                          // the last entry's reads done
      my[lane] = t;
      __syncwarp();
      if constexpr (kBoth) {
        float col[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float4 s = my[k];
          float c = kInf;
#pragma unroll
          for (int q = 0; q < kQL; ++q) {
            const float d = sq_dist(qx[q], qy[q], qz[q], s.x, s.y, s.z);
            best[q] = fminf(best[q], d);
            c = fminf(c, d);
          }
          col[k] = c;
        }
        const float m = reduce_scatter_min(col, lane);
        atomicMin(reinterpret_cast<int*>(sb) + (long long)j * kCols + lane,
                  __float_as_int(m));
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float4 s = my[k];
#pragma unroll
          for (int q = 0; q < kQL; ++q)
            best[q] = fminf(best[q],
                            sq_dist(qx[q], qy[q], qz[q], s.x, s.y, s.z));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQL; ++q) {
    const long long r = (long long)cur * kRows + q * 32 + lane;
    if (cur >= 0 && r < N)
      atomicMin(reinterpret_cast<int*>(sa) + r, __float_as_int(best[q]));
  }
}

// Round 0's sweep (the upper bounds' pass) and the later rounds': one body,
// two names, so that a profile tells them apart.
template <bool kBoth>
__global__ void __launch_bounds__(kBlock, 2) nn2_first_pass_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ list, int* cn, float* sa, float* sb, int N,
    int Tj) {
  sweep_list<kBoth>(a, b, list, cn, sa, sb, N, Tj);
}

template <bool kBoth>
__global__ void __launch_bounds__(kBlock, 2) nn2_sweep_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ list, int* cn, float* sa, float* sb, int N,
    int Tj) {
  sweep_list<kBoth>(a, b, list, cn, sa, sb, N, Tj);
}

// out_a[perm[r]] = sa[r], and in both directions out_b[perm[N + r] - N] =
// sb[r].
template <bool kBoth>
__global__ void __launch_bounds__(kBlock) nn2_unsort_kernel(
    const float* __restrict__ sa, const float* __restrict__ sb,
    const long long* __restrict__ perm, float* __restrict__ out_a,
    float* __restrict__ out_b, int N, int M) {
  const long long r = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (r < N) out_a[perm[r]] = sa[r];
  else if (kBoth && r < (long long)N + M) out_b[perm[r] - N] = sb[r - N];
}

inline bool sizes(int N, int M, int& Ti, int& Tj, int& W) {
  if (N <= 0 || M <= 0 || M % kCols) return false;
  Ti = (N + kRows - 1) / kRows;
  Tj = M / kCols;
  W = (Tj + 31) / 32;
  return (long long)Ti * Tj <= 0x7fffffffLL;
}


// The sweep over the plan (tulip_nn_h2 / tulip_nn_h1 below); in one
// direction thr holds Ti floats and wmax, sb, out_b are not used.
template <bool kBoth>
int run_pairs(const void* a_s, const void* b_s, const void* boxes,
              const void* perm, void* thr, void* wmax, void* smin, void* sa,
              void* sb, void* counts, void* done, void* list, void* out_a,
              void* out_b, int N, int M, cudaStream_t st) {
  int Ti, Tj, W;
  if (!sizes(N, M, Ti, Tj, W)) return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(a_s);
  const float* b = static_cast<const float*>(b_s);
  const float* ca = static_cast<const float*>(boxes);
  const float* ha = ca + 3LL * Ti;
  const float* cb = ha + 3LL * Ti;
  const float* hb = cb + 3LL * Tj;
  float* thr_a = static_cast<float*>(thr);
  float* thr_b = kBoth ? thr_a + Ti : nullptr;
  float* wm = static_cast<float*>(wmax);
  float* sm = static_cast<float*>(smin);
  float* fa = static_cast<float*>(sa);
  float* fb = static_cast<float*>(sb);
  int* cnt = static_cast<int*>(counts);
  unsigned* dn = static_cast<unsigned*>(done);
  int* ls = static_cast<int*>(list);

  cudaError_t err = cudaSuccess;
  if (kBoth && (err = cudaMemsetAsync(wm, 0, sizeof(float) * W, st)) !=
                   cudaSuccess)
    return err;
  const int rows = kBoth ? (Ti > Tj ? Ti : Tj) : Ti;
  nn2_bound_kernel<kBoth>
      <<<dim3((rows + kBlockWarps - 1) / kBlockWarps, kBoth ? 2 : 1), kBlock,
         0, st>>>(ca, ha, cb, hb, thr_a, thr_b, wm, sm, fa, fb, cnt, N, M,
                  Ti, Tj, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nn2_sweep_kernel<kBoth>, kBlock, 0);
  if (err != cudaSuccess) return err;
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  const int tiles = kBoth ? Ti + Tj : Ti;
  const float frac[kRounds] = {0.f, 1.f / 64, 1.f / 8, 1.f};
  for (int r = 0; r < kRounds; ++r) {
    if (r > 0) {
      if (kBoth && (err = cudaMemsetAsync(wm, 0, sizeof(float) * W, st)) !=
                       cudaSuccess)
        return err;
      nn2_ub_kernel<kBoth>
          <<<(tiles + kBlockWarps - 1) / kBlockWarps, kBlock, 0, st>>>(
              fa, fb, thr_a, thr_b, wm, frac[r], N, Ti, Tj);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    nn2_list_kernel<kBoth>
        <<<dim3(Ti, (W + 32 * kBlockWarps - 1) / (32 * kBlockWarps)), kBlock,
           0, st>>>(ca, ha, cb, hb, thr_a, thr_b, wm, sm, dn, ls,
                    cnt + 2 * r, r, Ti, Tj, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (r == 0)
      nn2_first_pass_kernel<kBoth><<<grid, kBlock, 0, st>>>(a, b, ls, cnt, fa,
                                                            fb, N, Tj);
    else
      nn2_sweep_kernel<kBoth><<<grid, kBlock, 0, st>>>(a, b, ls, cnt + 2 * r,
                                                       fa, fb, N, Tj);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long outs = kBoth ? (long long)N + M : N;
  nn2_unsort_kernel<kBoth>
      <<<(int)((outs + kBlock - 1) / kBlock), kBlock, 0, st>>>(
          fa, fb, static_cast<const long long*>(perm),
          static_cast<float*>(out_a), static_cast<float*>(out_b), N, M);
  return cudaGetLastError();
}

}  // namespace h2

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

// K5's plan, first half: codes (N + M) from a (N, 3), b (M, 3), with
// partial (6 x 264 floats) as scratch.  The wrapper argsorts the codes.
extern "C" int tulip_nn_h2_codes(const void* a, const void* b, void* partial,
                                 void* codes, int N, int M, void* stream) {
  using namespace tulip::nn::h2;
  int Ti, Tj, W;
  if (!sizes(N, M, Ti, Tj, W)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nn2_box_kernel<<<kBoxBlocks, kBlock, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(partial), N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn2_morton_kernel<<<kBoxBlocks, kBlock, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(partial), static_cast<int*>(codes), N, M);
  return cudaGetLastError();
}

// Second half: perm (N + M int64, the codes' stable argsort) -> a_s (N, 3),
// b_s (M, 3) and boxes (6 (Ti + Tj) floats: ca, ha, cb, hb).
extern "C" int tulip_nn_h2_gather(const void* a, const void* b,
                                  const void* perm, void* a_s, void* b_s,
                                  void* boxes, int N, int M, void* stream) {
  using namespace tulip::nn::h2;
  int Ti, Tj, W;
  if (!sizes(N, M, Ti, Tj, W)) return cudaErrorInvalidValue;
  nn2_gather_kernel<<<(Ti + Tj + kBlockWarps - 1) / kBlockWarps, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const long long*>(perm), static_cast<float*>(a_s),
      static_cast<float*>(b_s), static_cast<float*>(boxes), N, Ti, Tj);
  return cudaGetLastError();
}

// K5, the sweep over the plan: a_s, b_s, boxes, perm as the two calls
// above left them; scratch thr (Ti + Tj floats), wmax (W), smin (Ti x W),
// sa (N), sb (M), counts (2 x 4 ints: pairs listed, items taken, per
// round), done (Ti x W words, W = ceil(Tj / 32)), list (Ti x Tj ints);
// out_a (N,), out_b (M,) in the callers' order.
extern "C" int tulip_nn_h2(const void* a_s, const void* b_s,
                           const void* boxes, const void* perm, void* thr,
                           void* wmax, void* smin, void* sa, void* sb,
                           void* counts,
                           void* done, void* list, void* out_a, void* out_b,
                           int N, int M, void* stream) {
  return tulip::nn::h2::run_pairs<true>(
      a_s, b_s, boxes, perm, thr, wmax, smin, sa, sb, counts, done, list,
      out_a, out_b, N, M, static_cast<cudaStream_t>(stream));
}

// K6, one direction over the same plan: thr (Ti floats), smin, sa, counts,
// done and list as for K5; out (N,) in the callers' order.
extern "C" int tulip_nn_h1(const void* a_s, const void* b_s,
                           const void* boxes, const void* perm, void* thr,
                           void* smin, void* sa, void* counts, void* done,
                           void* list, void* out, int N, int M,
                           void* stream) {
  return tulip::nn::h2::run_pairs<false>(
      a_s, b_s, boxes, perm, thr, nullptr, smin, sa, nullptr, counts, done,
      list, out, nullptr, N, M, static_cast<cudaStream_t>(stream));
}
