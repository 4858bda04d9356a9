// Window attention core of the training path (K8 forward, K9 backward).
//
// Replaces tulip_tpu/ops/pallas/attn_core.py:_fwd_kernel and _bwd_kernel.
// From the fused projection qkv (B, H, W, 3C) = [q | k | v], per 2x8
// window of 16 tokens and head h (head dim 32):
//   forward   S = (q_h k_h^T) * scale + B_h [+ M_win],  P = softmax(S),
//             o_h = P v_h
//   backward  P recomputed from q, k and B (never stored: the point of the
//             TPU kernel); dv = P^T dO, dP = dO v^T,
//             dS = P * (dP - rowsum(dP * P)), dq = scale dS k,
//             dk = scale dS^T q, d(B_h) = sum over windows and batch of dS.
// B: the gathered relative-position bias (nh, 16, 16) fp32; M: the 0/-100
// shift mask of the window (nW, 16, 16) fp32, on shifted blocks.  The
// shifted window is addressing, as in window_msa.cu: token t of window
// (i, j) is x[(i wh + t / ww + sh) % H][(j ww + t % ww + sw) % W], so the
// roll(-s) before and the roll(+s) after the core cost no copies.
// Rounding points, bf16: logits, softmax (per-head max subtracted) and all
// accumulation fp32; P rounded before PV and before dv (as the TPU
// kernel); dS kept fp32 for d(B) and rounded before dq / dk; dq and dk
// scaled in fp32 after their products; o and dqkv rounded once.  The TPU
// layout (128-token groups, -1e9 block-diagonal mask, head-block-diagonal
// expansion, natural-token permutation) was an MXU workaround and is not
// carried over; its shared row max across heads (attn_core.py:130) is
// replaced by an exact per-head max.
//
// Bound on the H100: 4 x 16 x 16 x 32 MACs per window and head against
// 3 x 16 x 32 values in and 16 x 32 out (forward), 5 x 16 x 16 x 32 against
// 4 x 16 x 32 in and 3 x 16 x 32 out (backward): 8-11 operations a byte, so
// the bytes bind it, 30x below the tensor cores' ridge.
//
// bf16: attn_fwd_tc_kernel / attn_bwd_tc_kernel, whose design is to move
// those bytes at the card's rate:
//   - a tile is 4 windows = 64 token rows and a group of hg heads
//     (ops/attn_core.py:attn_core_plan; hg <= 3); grid (persistent CTAs,
//     head groups), a CTA walks tiles blockIdx.x, + gridDim.x, ...;
//   - each row's q | k | v (| dO) columns of the group arrive with 16-byte
//     cp.async copies, 2 hg threads a row, every copy of the tile in flight
//     at once, into padded rows (a row is 16 x an odd number of bytes, so
//     the 8 rows of an ldmatrix fall into 8 bank groups); the next tile's
//     copies run while this one is computed (two buffers);
//   - one warp per (window, head) of the tile: its 16 x 16 x 32 products on
//     mma.sync m16n8k16 (bf16 in, fp32 sums), operands from ldmatrix (B of
//     the products over tokens from ldmatrix.trans, P^T and dS^T from
//     movmatrix), the softmax of window_msa.cu's half-block (mma.cuh:
//     window_softmax); its results rounded into its own q (o; dq), k (dk)
//     and v (dv) slots of the tile, so no barrier inside a tile;
//   - one barrier, then the tile's rows go out as 16-byte stores;
//   - d(bias): a warp keeps one head for the CTA's whole walk, so its
//     partial is 8 fp32 registers a lane; at the end the CTA adds its four
//     window slots in order and writes part[cta][head]; tulip_colsum adds
//     the CTAs in order.  No atomics: the same inputs give the same bits.
// Measured: PERF.md section 6 (chip_smoke.py).
//
// fp32: attn_fwd_kernel / attn_bwd_kernel, the FMA kernels on the CUDA
// cores (one CTA of 256 threads per head and split of the windows, thread
// (i, j) owns logit (i, j)): the parity path, 1e-4 of the plain version.
#include "mma.cuh"

namespace tulip {

constexpr int kHD = 32;         // head dim
constexpr int kLd = kHD + 1;    // padded row: conflict-free column reads

struct WindowGeom {
  int H, W, C, wh, ww, sh, sw, nWw, nWin;
  // token index (b * H + row) * W + col of token t of window win of image b
  __device__ __forceinline__ long long token(int b, int win, int t) const {
    const int row = ((win / nWw) * wh + t / ww + sh) % H;
    const int col = ((win % nWw) * ww + t % ww + sw) % W;
    return ((long long)b * H + row) * W + col;
  }
};

// Stage q, k, v (and, with dout, dO) of head h for the 16 tokens tok[].
template <typename T>
__device__ void load_head(const T* qkv, const T* dout, const long long* tok,
                          int C, int h, float (*q)[kLd], float (*k)[kLd],
                          float (*v)[kLd], float (*dO)[kLd]) {
  for (int i = threadIdx.x; i < kRows * 3 * kHD; i += kThreads) {
    const int t = i / (3 * kHD), j = i % (3 * kHD);
    const int part = j / kHD, d = j % kHD;
    const float val = to_f(qkv[tok[t] * 3 * C + part * C + h * kHD + d]);
    (part == 0 ? q : part == 1 ? k : v)[t][d] = val;
  }
  if (dout)
    for (int i = threadIdx.x; i < kRows * kHD; i += kThreads) {
      const int t = i / kHD, d = i % kHD;
      dO[t][d] = to_f(dout[tok[t] * C + h * kHD + d]);
    }
}

// Row-wise softmax of logit (li, lj) over the 16 lanes of its half-warp.
__device__ __forceinline__ float softmax16(float s) {
  float m = s;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = expf(s - m);
  float sum = e;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return e / sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(
    const T* __restrict__ qkv, T* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ mask,
    WindowGeom geo, int nwin_total, float scale) {
  __shared__ float q[kRows][kLd], k[kRows][kLd], v[kRows][kLd];
  __shared__ float p[kRows][kRows + 1];
  __shared__ long long tok[kRows];
  const int h = blockIdx.x, C = geo.C;
  const int li = threadIdx.x >> 4, lj = threadIdx.x & 15;
  for (int w = blockIdx.y; w < nwin_total; w += gridDim.y) {
    const int b = w / geo.nWin, win = w % geo.nWin;
    if (threadIdx.x < kRows) tok[threadIdx.x] = geo.token(b, win, threadIdx.x);
    __syncthreads();
    load_head(qkv, static_cast<const T*>(nullptr), tok, C, h, q, k, v,
              static_cast<float (*)[kLd]>(nullptr));
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHD; ++d) s += q[li][d] * k[lj][d];
    s = s * scale + bias[(h * kRows + li) * kRows + lj];
    if (mask) s += mask[(win * kRows + li) * kRows + lj];
    p[li][lj] = round_to<T>(softmax16(s));
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = lj + 16 * half;
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) o += p[li][j] * v[j][d];
      out[tok[li] * C + h * kHD + d] = from_f<T>(o);
    }
    __syncthreads();   // q, k, v, p and tok are rewritten by the next window
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_kernel(
    const T* __restrict__ qkv, const T* __restrict__ dout,
    T* __restrict__ dqkv, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ part,
    WindowGeom geo, int nwin_total, float scale) {
  __shared__ float q[kRows][kLd], k[kRows][kLd], v[kRows][kLd];
  __shared__ float dO[kRows][kLd];
  __shared__ float pr[kRows][kRows + 1], ds[kRows][kRows + 1];
  __shared__ long long tok[kRows];
  const int h = blockIdx.x, C = geo.C;
  const int li = threadIdx.x >> 4, lj = threadIdx.x & 15;
  float dbias = 0.f;   // this thread's d(B_h)[li][lj] over its windows
  for (int w = blockIdx.y; w < nwin_total; w += gridDim.y) {
    const int b = w / geo.nWin, win = w % geo.nWin;
    if (threadIdx.x < kRows) tok[threadIdx.x] = geo.token(b, win, threadIdx.x);
    __syncthreads();
    load_head(qkv, dout, tok, C, h, q, k, v, dO);
    __syncthreads();
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < kHD; ++d) {
      s += q[li][d] * k[lj][d];
      dp += dO[li][d] * v[lj][d];
    }
    s = s * scale + bias[(h * kRows + li) * kRows + lj];
    if (mask) s += mask[(win * kRows + li) * kRows + lj];
    const float p32 = softmax16(s);
    const float t = p32 * dp;
    float rs = t;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
    const float dsv = t - p32 * rs;
    dbias += dsv;
    pr[li][lj] = round_to<T>(p32);
    ds[li][lj] = round_to<T>(dsv);
    __syncthreads();
    // thread (li, lj): dims lj, lj + 16 of token li as query (dq), as key
    // (dk) and as value (dv)
    T* dst = dqkv + tok[li] * 3 * C + h * kHD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = lj + 16 * half;
      float dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        dq += ds[li][j] * k[j][d];
        dk += ds[j][li] * q[j][d];
        dv += pr[j][li] * dO[j][d];
      }
      dst[d] = from_f<T>(dq * scale);
      dst[C + d] = from_f<T>(dk * scale);
      dst[2 * C + d] = from_f<T>(dv);
    }
    __syncthreads();
  }
  part[((size_t)blockIdx.y * gridDim.x + h) * kRows * kRows + threadIdx.x] =
      dbias;
}

inline cudaError_t make_geom(int H, int W, int C, int nh, int wh, int ww,
                             int sh, int sw, WindowGeom* geo) {
  if (wh * ww != kRows || C != nh * kHD || H % wh || W % ww || sh < 0 ||
      sw < 0)
    return cudaErrorInvalidValue;
  *geo = WindowGeom{H, W, C, wh, ww, sh, sw, W / ww, (H / wh) * (W / ww)};
  return cudaSuccess;
}

cudaError_t launch_attn_fwd(const float* qkv, float* out, const float* bias,
                            const float* mask, int B, int H, int W, int C,
                            int nh, int wh, int ww, int sh, int sw,
                            float scale, cudaStream_t stream) {
  WindowGeom geo;
  cudaError_t err = make_geom(H, W, C, nh, wh, ww, sh, sw, &geo);
  if (err != cudaSuccess) return err;
  const int total = B * geo.nWin;
  const dim3 grid(nh, min(total, 65535));
  attn_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(qkv, out, bias, mask,
                                                        geo, total, scale);
  return cudaGetLastError();
}

cudaError_t launch_attn_bwd(const float* qkv, const float* dout, float* dqkv,
                            const float* bias, const float* mask, float* part,
                            int B, int H, int W, int C, int nh, int wh,
                            int ww, int sh, int sw, int nsplit, float scale,
                            cudaStream_t stream) {
  WindowGeom geo;
  cudaError_t err = make_geom(H, W, C, nh, wh, ww, sh, sw, &geo);
  if (err != cudaSuccess) return err;
  const int total = B * geo.nWin;
  if (nsplit < 1 || nsplit > total || nsplit > 65535)
    return cudaErrorInvalidValue;
  attn_bwd_kernel<float><<<dim3(nh, nsplit), kThreads, 0, stream>>>(
      qkv, dout, dqkv, bias, mask, part, geo, total, scale);
  return cudaGetLastError();
}


namespace tc {

constexpr int kAttnWin = 4;                       // windows per tile
constexpr int kAttnRows = kAttnWin * kRows;       // token rows per tile
constexpr int kAttnMaxGroup = 3;                  // heads per group, at most
constexpr int kAttnThreads = 32 * kAttnWin * kAttnMaxGroup;

// The token grid (B, H, W, C) cut into wh x ww windows read with shift
// (sh, sw): nW windows an image, nWw a window row, windows over the batch,
// tiles of kAttnWin windows.
struct AttnGeom {
  int H, W, C, wh, ww, sh, sw, nW, nWw, windows, tiles;
};

// Token index (b * H + row) * W + col of row r of tile `tile`, or -1 where
// the tile's window lies beyond the batch.
__device__ __forceinline__ long long attn_token(const AttnGeom& g, int tile,
                                                int r) {
  const int wg = tile * kAttnWin + (r >> 4);
  if (wg >= g.windows) return -1;
  const int t = r & 15;
  const int b = wg / g.nW, win = wg - b * g.nW;
  const int wi = win / g.nWw, wj = win - wi * g.nWw;
  const int row = (wi * g.wh + t / g.ww + g.sh) % g.H;
  const int col = (wj * g.ww + t % g.ww + g.sw) % g.W;
  return ((long long)b * g.H + row) * g.W + col;
}

// One (window, head) of a tile, in its warp.  slot: the window's first row
// in the tile at the head's q columns; rs: bytes a tile row; ps: bytes
// between the q, k, v (, dO) parts of a row.  Lane address patterns of the
// four 8 x 8 matrices of an ldmatrix over 16 tokens x 16 dims:
//   a_off  rows lane % 16, dims + 8 (lane / 16): the A fragment of the
//          rows (tokens along M), or with .trans the two B fragments of
//          two 8-dim column tiles of the rows (tokens along K);
//   b_off  rows lane % 8 + 8 (lane / 16), dims + 8 (lane / 8 % 2): the B
//          fragments of two 8-token column tiles (tokens along N).
struct PairAddr {
  uint32_t q, k, v, dO;   // ldmatrix bases of the four parts
  uint32_t a_off, b_off;
};

__device__ __forceinline__ PairAddr pair_addr(const unsigned char* slot,
                                              int rs, int ps) {
  const int lane = threadIdx.x & 31;
  const uint32_t base = smem_u32(slot);
  return PairAddr{base, base + ps, base + 2 * ps, base + 3 * ps,
                  (uint32_t)((lane & 15) * rs + (lane >> 4) * 16),
                  (uint32_t)(((lane & 7) + 8 * (lane >> 4)) * rs +
                             ((lane >> 3) & 1) * 16)};
}

// s (+)= X Y^T over the 32 dims, X (rows) and Y (columns) 16 tokens each.
__device__ __forceinline__ void mma_rows_rows(float (&s)[2][4], uint32_t x,
                                              uint32_t y, const PairAddr& a) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t xa[4], yb[4];
    ldsm_x4(xa, x + a.a_off + 32 * ks);
    ldsm_x4(yb, y + a.b_off + 32 * ks);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma_m16n8k16(s[nt], xa, yb[2 * nt], yb[2 * nt + 1]);
  }
}

// B fragments of dims 16 ks .. 16 ks + 15 of the 16 x 32 rows at x, tokens
// along K: b[0..1] for the 8-dim column tile 2 ks, b[2..3] for 2 ks + 1.
__device__ __forceinline__ void ldsm_rows_b(uint32_t (&b)[4], uint32_t x,
                                            int ks, const PairAddr& a) {
  ldsm_x4_trans(b, x + a.a_off + 32 * ks);
}

// Round (v * mul) of 8-dim column tile dt of a 16 x 32 result into the
// tile at slot (the warp's own rows and columns).
__device__ __forceinline__ void put_tile(unsigned char* slot, int rs, int dt,
                                         const float (&v)[4], float mul) {
  const int lane = threadIdx.x & 31;
  unsigned char* p = slot + (lane >> 2) * rs + (8 * dt + 2 * (lane & 3)) * 2;
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0] * mul, v[1] * mul);
  *reinterpret_cast<uint32_t*>(p + 8 * rs) = pack_bf16(v[2] * mul, v[3] * mul);
}

// o = softmax(q k^T scale + bias + mask) v, rounded over q's slot.
__device__ __forceinline__ void attn_fwd_pair(unsigned char* slot, int rs,
                                              int ps, const float (&bh)[8],
                                              const float (&mk)[8],
                                              float scale) {
  const PairAddr a = pair_addr(slot, rs, ps);
  float s[2][4] = {};
  mma_rows_rows(s, a.q, a.k, a);
  window_softmax(s, bh, mk, scale);
  uint32_t pa[4];
  pack_a(s, pa);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t vb[4];
    ldsm_rows_b(vb, a.v, ks, a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float o[4] = {};
      mma_m16n8k16(o, pa, vb[2 * h], vb[2 * h + 1]);
      put_tile(slot, rs, 2 * ks + h, o, 1.f);   // q's dims, read above
    }
  }
}

// dq, dk, dv of one (window, head), rounded over its q, k, v slots; the
// unrounded dS added to db (load_frag16 order).
__device__ __forceinline__ void attn_bwd_pair(unsigned char* slot, int rs,
                                              int ps, const float (&bh)[8],
                                              const float (&mk)[8],
                                              float scale, float (&db)[8]) {
  const PairAddr a = pair_addr(slot, rs, ps);
  float s[2][4] = {}, dp[2][4] = {};
  mma_rows_rows(s, a.q, a.k, a);
  mma_rows_rows(dp, a.dO, a.v, a);
  window_softmax(s, bh, mk, scale);   // s: P in fp32
  float ds[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e = 2 * half;
    const float t00 = s[0][e] * dp[0][e], t01 = s[0][e + 1] * dp[0][e + 1];
    const float t10 = s[1][e] * dp[1][e], t11 = s[1][e + 1] * dp[1][e + 1];
    float r = (t00 + t01) + (t10 + t11);
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    ds[0][e] = t00 - s[0][e] * r;
    ds[0][e + 1] = t01 - s[0][e + 1] * r;
    ds[1][e] = t10 - s[1][e] * r;
    ds[1][e + 1] = t11 - s[1][e + 1] * r;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) db[4 * nt + i] += ds[nt][i];
  uint32_t pa[4], pta[4], dsa[4], dsta[4];
  pack_a(s, pa);
  pack_a(ds, dsa);
  transpose_a(pa, pta);
  transpose_a(dsa, dsta);
  // per 16 dims: the B operands of dO, q and k read, then dq, dk, dv of
  // those dims written over them (no lane reads them again)
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t dob[4], qb[4], kb[4];
    ldsm_rows_b(dob, a.dO, ks, a);
    ldsm_rows_b(qb, a.q, ks, a);
    ldsm_rows_b(kb, a.k, ks, a);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dt = 2 * ks + h;
      float dv[4] = {}, dk[4] = {}, dq[4] = {};
      mma_m16n8k16(dv, pta, dob[2 * h], dob[2 * h + 1]);   // P^T dO
      mma_m16n8k16(dk, dsta, qb[2 * h], qb[2 * h + 1]);    // dS^T q
      mma_m16n8k16(dq, dsa, kb[2 * h], kb[2 * h + 1]);     // dS k
      put_tile(slot, rs, dt, dq, scale);
      put_tile(slot + ps, rs, dt, dk, scale);
      put_tile(slot + 2 * ps, rs, dt, dv, 1.f);
    }
  }
}

// grid (CTAs, head groups), 128 hg threads: warp w takes window w / hg of
// each tile and head h0 + w % hg.  Shared memory: two tiles of 64 rows of
// rs = 64 hg PARTS + 16 bytes; PARTS 3 (q, k, v) forward, 4 (+ dO)
// backward.  Thread t gathers and stores row t / (2 hg), chunks t % (2 hg)
// + 2 hg k: the same thread rewrites a chunk it has stored, so the next
// gather into a buffer needs no barrier after the stores.
template <bool BWD>
__device__ __forceinline__ void attn_tc(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    bf16* __restrict__ out, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ part,
    const AttnGeom& g, int nh, int hg, float scale) {
  constexpr int kParts = BWD ? 4 : 3;     // of a head: q, k, v (, dO)
  constexpr int kOut = BWD ? 3 : 1;       // o; dq, dk, dv
  extern __shared__ uint4 attn_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(attn_smem);
  const int C = g.C;
  const int ps = hg * 64, rs = kParts * ps + 16;
  const int buf_bytes = kAttnRows * rs;   // one tile
  const int h0 = blockIdx.y * hg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int win = warp / hg, hl = warp - win * hg;
  const int tpr = 2 * hg;
  const int r = threadIdx.x / tpr, j = threadIdx.x - r * tpr;

  auto gather = [&](unsigned char* buf, long long tok) {
    if (tok < 0) return;
    const uint32_t dst = smem_u32(buf + r * rs);
    const bf16* q0 = qkv + tok * 3 * C + h0 * kHD;
#pragma unroll
    for (int k = 0; k < 2 * kParts; ++k) {
      const int p = k >> 1, w = j + tpr * (k & 1);
      const bf16* src = p < 3 ? q0 + p * C + w * 8
                              : dout + tok * C + h0 * kHD + w * 8;
      cp_async16(dst + (j + tpr * k) * 16, src, true);
    }
  };
  auto store = [&](const unsigned char* buf, long long tok) {
    if (tok < 0) return;
    const unsigned char* src = buf + r * rs;
    bf16* d0 = out + tok * kOut * C + h0 * kHD;
#pragma unroll
    for (int k = 0; k < 2 * kOut; ++k) {
      const int p = k >> 1, w = j + tpr * (k & 1);
      *reinterpret_cast<uint4*>(d0 + p * C + w * 8) =
          *reinterpret_cast<const uint4*>(src + (j + tpr * k) * 16);
    }
  };

  float bh[8], db[8] = {};
  load_frag16(bias + (size_t)(h0 + hl) * kRows * kRows, bh);
  int tile = blockIdx.x;
  long long tok_next = attn_token(g, tile, r);
  gather(sm, tok_next);
  cp_async_commit();
  for (int n = 0; tile < g.tiles; ++n, tile += gridDim.x) {
    unsigned char* buf = sm + (n & 1) * buf_bytes;
    const long long tok = tok_next;
    const int next = tile + gridDim.x;
    tok_next = next < g.tiles ? attn_token(g, next, r) : -1;
    gather(sm + ((n & 1) ^ 1) * buf_bytes, tok_next);
    cp_async_commit();
    const int wg = tile * kAttnWin + win;
    float mk[8] = {};
    if (mask && wg < g.windows)
      load_frag16(mask + (size_t)(wg % g.nW) * kRows * kRows, mk);
    cp_async_wait<1>();
    __syncthreads();   // the tile has landed
    if (wg < g.windows) {
      unsigned char* slot = buf + win * kRows * rs + hl * 64;
      if constexpr (BWD)
        attn_bwd_pair(slot, rs, ps, bh, mk, scale, db);
      else
        attn_fwd_pair(slot, rs, ps, bh, mk, scale);
    }
    __syncthreads();   // every warp's results are in the tile
    store(buf, tok);
  }
  if constexpr (BWD) {
    // d(bias): the four window slots of each head added in order
    __syncthreads();
    float* red = reinterpret_cast<float*>(sm);   // [hg][kAttnWin][32][8]
    float4* mine = reinterpret_cast<float4*>(
        red + ((hl * kAttnWin + win) * 32 + lane) * 8);
    mine[0] = make_float4(db[0], db[1], db[2], db[3]);
    mine[1] = make_float4(db[4], db[5], db[6], db[7]);
    __syncthreads();
    for (int i = threadIdx.x; i < hg * kRows * kRows; i += blockDim.x) {
      const int h = i >> 8, e = i & 255, row = e >> 4, col = e & 15;
      const int ln = (row & 7) * 4 + ((col & 7) >> 1);
      const int k = (col >> 3) * 4 + (row >> 3) * 2 + (col & 1);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kAttnWin; ++w)
        sum += red[((h * kAttnWin + w) * 32 + ln) * 8 + k];
      part[((size_t)blockIdx.x * nh + h0 + h) * kRows * kRows + e] = sum;
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads, 2) attn_fwd_tc_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const AttnGeom g, int nh, int hg, float scale) {
  attn_tc<false>(qkv, nullptr, out, bias, mask, nullptr, g, nh, hg, scale);
}

__global__ void __launch_bounds__(kAttnThreads, 2) attn_bwd_tc_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ part,
    const AttnGeom g, int nh, int hg, float scale) {
  attn_tc<true>(qkv, dout, dqkv, bias, mask, part, g, nh, hg, scale);
}

// Plan (ops/attn_core.py:attn_core_plan): ctas along the tiles, hg heads a
// group, smem bytes.  The launch is refused, not reshaped, when the plan
// and the kernel's needs differ.
cudaError_t launch_attn_tc(bool bwd, const bf16* qkv, const bf16* dout,
                           bf16* out, const float* bias, const float* mask,
                           float* part, int B, int H, int W, int C, int nh,
                           int wh, int ww, int sh, int sw, int ctas, int hg,
                           int smem, float scale, cudaStream_t stream) {
  if (wh * ww != kRows || C != nh * kHD || B <= 0 || H <= 0 || W <= 0 ||
      H % wh || W % ww || sh < 0 || sw < 0 || hg < 1 || hg > kAttnMaxGroup ||
      nh % hg || nh / hg > 65535 || (bwd && !part))
    return cudaErrorInvalidValue;
  AttnGeom g;
  g.H = H, g.W = W, g.C = C, g.wh = wh, g.ww = ww, g.sh = sh, g.sw = sw;
  g.nWw = W / ww, g.nW = (H / wh) * g.nWw;
  g.windows = B * g.nW;
  g.tiles = (g.windows + kAttnWin - 1) / kAttnWin;
  const int need = 2 * kAttnRows * (hg * (bwd ? 4 : 3) * 64 + 16);
  if (smem != need || ctas < 1 || ctas > g.tiles) return cudaErrorInvalidValue;
  const dim3 grid(ctas, nh / hg);
  cudaError_t err;
  if (bwd) {
    if ((err = prepare_smem(attn_bwd_tc_kernel, need)) != cudaSuccess)
      return err;
    attn_bwd_tc_kernel<<<grid, 32 * kAttnWin * hg, need, stream>>>(
        qkv, dout, out, bias, mask, part, g, nh, hg, scale);
  } else {
    if ((err = prepare_smem(attn_fwd_tc_kernel, need)) != cudaSuccess)
      return err;
    attn_fwd_tc_kernel<<<grid, 32 * kAttnWin * hg, need, stream>>>(
        qkv, out, bias, mask, g, nh, hg, scale);
  }
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// fp32: the FMA kernel, the plan (ctas, hg, smem) not read.  bf16: the
// mma.sync kernel under that plan.
extern "C" int tulip_attn_fwd(int dtype, const void* qkv, void* out,
                              const void* bias, const void* mask, int B,
                              int H, int W, int C, int nh, int wh, int ww,
                              int sh, int sw, int ctas, int hg, int smem,
                              float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return tulip::launch_attn_fwd(static_cast<const float*>(qkv),
                                  static_cast<float*>(out), b, m, B, H, W, C,
                                  nh, wh, ww, sh, sw, scale, s);
  if (dtype == 1)
    return tulip::tc::launch_attn_tc(
        false, static_cast<const bf16*>(qkv), nullptr, static_cast<bf16*>(out),
        b, m, nullptr, B, H, W, C, nh, wh, ww, sh, sw, ctas, hg, smem, scale,
        s);
  return cudaErrorInvalidValue;
}

// part: (nsplit, nh, 16, 16) fp32 d(bias) partials, one row per split
// (fp32) or per CTA along the tiles (bf16: nsplit = the plan's ctas)
extern "C" int tulip_attn_bwd(int dtype, const void* qkv, const void* dout,
                              void* dqkv, const void* bias, const void* mask,
                              void* part, int B, int H, int W, int C, int nh,
                              int wh, int ww, int sh, int sw, int nsplit,
                              int hg, int smem, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return tulip::launch_attn_bwd(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), b, m, static_cast<float*>(part), B, H, W,
        C, nh, wh, ww, sh, sw, nsplit, scale, s);
  if (dtype == 1)
    return tulip::tc::launch_attn_tc(
        true, static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), b, m, static_cast<float*>(part), B, H, W, C,
        nh, wh, ww, sh, sw, nsplit, hg, smem, scale, s);
  return cudaErrorInvalidValue;
}
