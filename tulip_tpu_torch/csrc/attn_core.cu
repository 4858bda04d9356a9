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
// the bytes bind it, 30x below the tensor cores' ridge; in fp32, twice
// the bytes and three TF32 products a product, still 9x below it.
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
// fp32: attn_fwd_tf32_kernel / attn_bwd_tf32_kernel, the same copies,
// warps and d(bias) sums with the products in split TF32 (mma.cuh: hi /
// lo halves, three m16n8k8 TF32 products a product, small terms first):
//   - a row of a head's part is 32 fp32 = 128 bytes, so a tile row of hg
//     heads is 128 hg PARTS + 16 bytes: R = 32 hg PARTS + 4 words, R = 4
//     (mod 32).  A tile is 2 windows (kAttnF32Win) of up to 3 heads: 75 KB
//     forward, three blocks an SM, 99 KB backward, two; of seven shapes
//     timed it ties with one window and beats the others (PERF.md,
//     section 6).  ldmatrix reads fp32 as
//     pairs of b16: lane 4 g + q gets
//     word q of row g of an 8 x 4-float matrix, which is the TF32 A
//     fragment (rows along M, dims along K) and the B fragment of the
//     rows' transpose (tokens along N), so S = q k^T and dP = dO v^T load
//     as the bf16 pair does (a_off / b_off; the rows' 16-byte chunks sit
//     in 8 bank groups since R / 4 is odd);
//   - products over tokens (P v, dS k, dS^T q, P^T dO) take their B
//     operand, token k = 8 kt + 2 q + {0, 1} and dim 8 dt + g, by 4-byte
//     loads: word (8 kt + 2 q) R + 8 dt + g is bank 8 q + g + 8 dt (mod
//     32), 32 banks for 32 lanes.  The key tokens go in that order in
//     both operands: the A operand is a D fragment as it is (lane 4 g + q
//     holds columns 2 q, 2 q + 1);
//   - movmatrix and ldmatrix.trans move 16-bit elements only, so P^T and
//     dS^T go through shared memory: P and dS are written to the warp's
//     own v slot (v is read by then) as rows of R words and read back
//     down the columns, word (8 kt + 2 q + e) R + g (+ 8): bank 8 q + 4 e
//     + g (+ 8), again 32 banks.  (The writes, float2 at row g, column 8
//     nt + 2 q, fall 2-way: any R = 4 (mod 8) that the reads need puts
//     rows g and g + 1 4 words apart.)  Taking P^T as the softmax of k
//     q^T instead costs two more 16 x 16 x 32 products (dP^T too) and
//     the row statistics through shuffles, for what are 8 float2 stores
//     and 16 loads a lane here: measured 11-13 % slower (PERF.md,
//     section 6);
//   - a fragment that feeds several products (q's in S, P's and dS's in
//     the products over tokens) is split into hi / lo once.
// The rounding points are the plain version's: none below fp32.
// Measured: PERF.md section 6 (chip_smoke.py).
#include "mma.cuh"

namespace tulip {
namespace tc {

constexpr int kHD = 32;                           // head dim
constexpr int kAttnWin = 4;                       // windows per tile, bf16
constexpr int kAttnMaxGroup = 3;                  // heads per group, bf16
constexpr int kAttnThreads = 32 * kAttnWin * kAttnMaxGroup;
// fp32: windows per tile and heads per group, at most
// (ops/attn_core.py:_TILE_WINDOWS, _MAX_GROUP), and the blocks an SM holds
// by shared memory, which the launch bounds promise.
constexpr int kAttnF32Win = 2;
constexpr int kAttnF32Group = 3;
constexpr int kAttnF32Threads = 32 * kAttnF32Win * kAttnF32Group;
// shared bytes an SM offers blocks (228 KB), and what each block takes
// beside its dynamic shared memory (ops/window_msa.py:SM_SMEM)
constexpr int kSmSmem = 233472;
constexpr int kBlockSmemExtra = 1024;

// Shared bytes of a kernel's two tiles: 16 win rows of hg heads' parts (q,
// k, v and, backward, dO) of 32 elements, and 16 bytes of pad a row.
__host__ __device__ constexpr int attn_smem(int esz, int parts, int hg,
                                            int win) {
  return 2 * kRows * win * (hg * parts * kHD * esz + 16);
}
// blocks of the largest fp32 group an SM holds, forward and backward
constexpr int kAttnF32FwdBlocks =
    kSmSmem / (attn_smem(4, 3, kAttnF32Group, kAttnF32Win) + kBlockSmemExtra);
constexpr int kAttnF32BwdBlocks =
    kSmSmem / (attn_smem(4, 4, kAttnF32Group, kAttnF32Win) + kBlockSmemExtra);

// The token grid (B, H, W, C) cut into wh x ww windows read with shift
// (sh, sw): nW windows an image, nWw a window row, windows over the batch,
// tiles of WIN windows.
struct AttnGeom {
  int H, W, C, wh, ww, sh, sw, nW, nWw, windows, tiles;
};

// Token index (b * H + row) * W + col of row r of tile `tile`, or -1 where
// the tile's window lies beyond the batch.
template <int WIN>
__device__ __forceinline__ long long attn_token(const AttnGeom& g, int tile,
                                                int r) {
  const int wg = tile * WIN + (r >> 4);
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
// four 8 x 16-byte matrices of an ldmatrix over 16 tokens x 16 bytes:
//   a_off  rows lane % 16, bytes + 16 (lane / 16): the A fragment of the
//          rows (tokens along M), or with .trans the two B fragments of
//          two 8-dim column tiles of the rows (tokens along K; bf16);
//   b_off  rows lane % 8 + 8 (lane / 16), bytes + 16 (lane / 8 % 2): the
//          B fragments of two 8-token column tiles (tokens along N).
// Both hold for bf16 (16 dims a matrix row pair) and fp32 (8 dims).
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

// ds = P * (dP - rowsum(dP * P)) of the logits' D tiles, fp32; a row's
// sum over the 4 lanes that share it; ds added to db (load_frag16 order).
__device__ __forceinline__ void dsoftmax(const float (&p)[2][4],
                                         const float (&dp)[2][4],
                                         float (&ds)[2][4], float (&db)[8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int e = 2 * half;
    const float t00 = p[0][e] * dp[0][e], t01 = p[0][e + 1] * dp[0][e + 1];
    const float t10 = p[1][e] * dp[1][e], t11 = p[1][e + 1] * dp[1][e + 1];
    float r = (t00 + t01) + (t10 + t11);
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    ds[0][e] = t00 - p[0][e] * r;
    ds[0][e + 1] = t01 - p[0][e + 1] * r;
    ds[1][e] = t10 - p[1][e] * r;
    ds[1][e + 1] = t11 - p[1][e + 1] * r;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) db[4 * nt + i] += ds[nt][i];
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
  dsoftmax(s, dp, ds, db);
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

// --- fp32: split TF32 -------------------------------------------------------

// A TF32 operand fragment split into hi / lo once, for several products.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ Tf32Frag split_frag(float a0, float a1, float a2,
                                               float a3) {
  Tf32Frag f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}
// The A operand of a product over the key tokens from a 16 x 16 matrix
// held as D tiles (rows: s[.][0..1] row g, s[.][2..3] row g + 8): tile kt,
// keys in the order 8 kt + 2 q, then 8 kt + 2 q + 1 (mma.cuh).
__device__ __forceinline__ Tf32Frag split_d(const float (&s)[4]) {
  return split_frag(s[0], s[2], s[1], s[3]);
}

// d += A B in split TF32, A split, b0 / b1 fp32 (the small terms first).
__device__ __forceinline__ void mma3_split(float (&d)[4], const Tf32Frag& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// s (+)= X Y^T over the 32 fp32 dims (4 k-steps of 8), X (rows) and Y
// (columns) 16 tokens each; X's fragment split once for both column tiles.
__device__ __forceinline__ void mma_rows_rows_f32(float (&s)[2][4],
                                                  uint32_t x, uint32_t y,
                                                  const PairAddr& a) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t xa[4], yb[4];
    ldsm_x4(xa, x + a.a_off + 32 * ks);
    ldsm_x4(yb, y + a.b_off + 32 * ks);
    const Tf32Frag xf =
        split_frag(__uint_as_float(xa[0]), __uint_as_float(xa[1]),
                   __uint_as_float(xa[2]), __uint_as_float(xa[3]));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      mma3_split(s[nt], xf, __uint_as_float(yb[2 * nt]),
                 __uint_as_float(yb[2 * nt + 1]));
  }
}

// d += A X[tokens, dims 8 dt ..] over the 16 tokens of the rows at x (R
// floats a row): B fragment (token 8 kt + 2 q (+ 1), dim 8 dt + g).
__device__ __forceinline__ void mma_tokens_f32(float (&d)[4],
                                               const Tf32Frag (&a)[2],
                                               const float* x, int R,
                                               int dt) {
  const int lane = threadIdx.x & 31;
  const float* p = x + 2 * (lane & 3) * R + 8 * dt + (lane >> 2);
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
    mma3_split(d, a[kt], p[8 * kt * R], p[(8 * kt + 1) * R]);
}

// (v * mul) of 8-dim column tile dt of a 16 x 32 result into the tile at
// slot (the warp's own rows and columns), fp32.
__device__ __forceinline__ void put_tile_f32(unsigned char* slot, int rs,
                                             int dt, const float (&v)[4],
                                             float mul) {
  const int lane = threadIdx.x & 31;
  unsigned char* p = slot + (lane >> 2) * rs + (8 * dt + 2 * (lane & 3)) * 4;
  *reinterpret_cast<float2*>(p) = make_float2(v[0] * mul, v[1] * mul);
  *reinterpret_cast<float2*>(p + 8 * rs) = make_float2(v[2] * mul,
                                                       v[3] * mul);
}

// o = softmax(q k^T scale + bias + mask) v over q's slot, fp32.
__device__ __forceinline__ void attn_fwd_pair_f32(unsigned char* slot, int rs,
                                                  int ps,
                                                  const float (&bh)[8],
                                                  const float (&mk)[8],
                                                  float scale) {
  const PairAddr a = pair_addr(slot, rs, ps);
  float s[2][4] = {};
  mma_rows_rows_f32(s, a.q, a.k, a);
  window_softmax(s, bh, mk, scale);
  const Tf32Frag pf[2] = {split_d(s[0]), split_d(s[1])};
  const float* v = reinterpret_cast<const float*>(slot + 2 * ps);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    float o[4] = {};
    mma_tokens_f32(o, pf, v, rs / 4, dt);
    put_tile_f32(slot, rs, dt, o, 1.f);   // q's dims, read above
  }
}

// dq, dk, dv of one (window, head) over its q, k, v slots, fp32; dS added
// to db (load_frag16 order).
__device__ __forceinline__ void attn_bwd_pair_f32(unsigned char* slot, int rs,
                                                  int ps,
                                                  const float (&bh)[8],
                                                  const float (&mk)[8],
                                                  float scale,
                                                  float (&db)[8]) {
  const PairAddr a = pair_addr(slot, rs, ps);
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  const int R = rs / 4;
  float s[2][4] = {}, dp[2][4] = {};
  mma_rows_rows_f32(s, a.q, a.k, a);
  mma_rows_rows_f32(dp, a.dO, a.v, a);
  window_softmax(s, bh, mk, scale);   // s: P
  float ds[2][4];
  dsoftmax(s, dp, ds, db);
  const Tf32Frag dsf[2] = {split_d(ds[0]), split_d(ds[1])};
  // P (columns 0-15) and dS (16-31) to the v slot, read back transposed
  float* sc = reinterpret_cast<float*>(slot + 2 * ps);
  __syncwarp();   // every lane's v is read
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = sc + (g + 8 * h) * R + 8 * nt + 2 * qd;
      *reinterpret_cast<float2*>(row) =
          make_float2(s[nt][2 * h], s[nt][2 * h + 1]);
      *reinterpret_cast<float2*>(row + 16) =
          make_float2(ds[nt][2 * h], ds[nt][2 * h + 1]);
    }
  __syncwarp();
  Tf32Frag ptf[2], dstf[2];   // P^T, dS^T: keys along M, queries along K
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const float* r0 = sc + (8 * kt + 2 * qd) * R + g;
    const float* r1 = r0 + R;
    ptf[kt] = split_frag(r0[0], r0[8], r1[0], r1[8]);
    dstf[kt] = split_frag(r0[16], r0[24], r1[16], r1[24]);
  }
  __syncwarp();   // read before dv is written over them
  const float* q = reinterpret_cast<const float*>(slot);
  const float* k = reinterpret_cast<const float*>(slot + ps);
  const float* dO = reinterpret_cast<const float*>(slot + 3 * ps);
  // per 8 dims: q, k and dO read, then dq, dk, dv of those dims written
  // over them (no lane reads them again)
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    float dq[4] = {}, dk[4] = {}, dv[4] = {};
    mma_tokens_f32(dq, dsf, k, R, dt);    // dS k
    mma_tokens_f32(dk, dstf, q, R, dt);   // dS^T q
    mma_tokens_f32(dv, ptf, dO, R, dt);   // P^T dO
    __syncwarp();
    put_tile_f32(slot, rs, dt, dq, scale);
    put_tile_f32(slot + ps, rs, dt, dk, scale);
    put_tile_f32(slot + 2 * ps, rs, dt, dv, 1.f);
  }
}

// grid (CTAs, head groups), 32 WIN hg threads: warp w takes window w / hg
// of each tile of WIN windows and head h0 + w % hg.  Shared memory: two
// tiles of 16 WIN rows of rs = 32 hg PARTS sizeof(T) + 16 bytes; PARTS 3
// (q, k, v) forward, 4 (+ dO) backward.  Thread t gathers and stores row
// t / (2 hg), chunks t % (2 hg) + 2 hg k: the same thread rewrites a chunk
// it has stored, so the next gather into a buffer needs no barrier after
// the stores.
template <typename T, bool BWD, int WIN>
__device__ __forceinline__ void attn_tc(
    const T* __restrict__ qkv, const T* __restrict__ dout,
    T* __restrict__ out, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ part,
    const AttnGeom& g, int nh, int hg, float scale) {
  constexpr int kParts = BWD ? 4 : 3;     // of a head: q, k, v (, dO)
  constexpr int kOut = BWD ? 3 : 1;       // o; dq, dk, dv
  constexpr int kEl = 16 / sizeof(T);     // elements of a 16-byte chunk
  constexpr int kCpt = sizeof(T);         // a thread's chunks of a part
  extern __shared__ uint4 attn_smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(attn_smem_raw);
  const int C = g.C;
  const int ps = hg * kHD * (int)sizeof(T), rs = kParts * ps + 16;
  const int buf_bytes = WIN * kRows * rs;   // one tile
  const int h0 = blockIdx.y * hg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int win = warp / hg, hl = warp - win * hg;
  const int tpr = 2 * hg;
  const int r = threadIdx.x / tpr, j = threadIdx.x - r * tpr;

  auto gather = [&](unsigned char* buf, long long tok) {
    if (tok < 0) return;
    const uint32_t dst = smem_u32(buf + r * rs);
    const T* q0 = qkv + tok * 3 * C + h0 * kHD;
#pragma unroll
    for (int k = 0; k < kCpt * kParts; ++k) {
      const int p = k / kCpt, w = j + tpr * (k % kCpt);
      const T* src = p < 3 ? q0 + p * C + w * kEl
                           : dout + tok * C + h0 * kHD + w * kEl;
      cp_async16(dst + (j + tpr * k) * 16, src, true);
    }
  };
  auto store = [&](const unsigned char* buf, long long tok) {
    if (tok < 0) return;
    const unsigned char* src = buf + r * rs;
    T* d0 = out + tok * kOut * C + h0 * kHD;
#pragma unroll
    for (int k = 0; k < kCpt * kOut; ++k) {
      const int p = k / kCpt, w = j + tpr * (k % kCpt);
      *reinterpret_cast<uint4*>(d0 + p * C + w * kEl) =
          *reinterpret_cast<const uint4*>(src + (j + tpr * k) * 16);
    }
  };

  float bh[8], db[8] = {};
  load_frag16(bias + (size_t)(h0 + hl) * kRows * kRows, bh);
  int tile = blockIdx.x;
  long long tok_next = attn_token<WIN>(g, tile, r);
  gather(sm, tok_next);
  cp_async_commit();
  for (int n = 0; tile < g.tiles; ++n, tile += gridDim.x) {
    unsigned char* buf = sm + (n & 1) * buf_bytes;
    const long long tok = tok_next;
    const int next = tile + gridDim.x;
    tok_next = next < g.tiles ? attn_token<WIN>(g, next, r) : -1;
    gather(sm + ((n & 1) ^ 1) * buf_bytes, tok_next);
    cp_async_commit();
    const int wg = tile * WIN + win;
    float mk[8] = {};
    if (mask && wg < g.windows)
      load_frag16(mask + (size_t)(wg % g.nW) * kRows * kRows, mk);
    cp_async_wait<1>();
    __syncthreads();   // the tile has landed
    if (wg < g.windows) {
      unsigned char* slot = buf + win * kRows * rs + hl * kHD * sizeof(T);
      if constexpr (BWD) {
        if constexpr (sizeof(T) == 4)
          attn_bwd_pair_f32(slot, rs, ps, bh, mk, scale, db);
        else
          attn_bwd_pair(slot, rs, ps, bh, mk, scale, db);
      } else {
        if constexpr (sizeof(T) == 4)
          attn_fwd_pair_f32(slot, rs, ps, bh, mk, scale);
        else
          attn_fwd_pair(slot, rs, ps, bh, mk, scale);
      }
    }
    __syncthreads();   // every warp's results are in the tile
    store(buf, tok);
  }
  if constexpr (BWD) {
    // d(bias): the four window slots of each head added in order
    __syncthreads();
    float* red = reinterpret_cast<float*>(sm);   // [hg][WIN][32][8]
    float4* mine = reinterpret_cast<float4*>(
        red + ((hl * WIN + win) * 32 + lane) * 8);
    mine[0] = make_float4(db[0], db[1], db[2], db[3]);
    mine[1] = make_float4(db[4], db[5], db[6], db[7]);
    __syncthreads();
    for (int i = threadIdx.x; i < hg * kRows * kRows; i += blockDim.x) {
      const int h = i >> 8, e = i & 255, row = e >> 4, col = e & 15;
      const int ln = (row & 7) * 4 + ((col & 7) >> 1);
      const int k = (col >> 3) * 4 + (row >> 3) * 2 + (col & 1);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WIN; ++w)
        sum += red[((h * WIN + w) * 32 + ln) * 8 + k];
      part[((size_t)blockIdx.x * nh + h0 + h) * kRows * kRows + e] = sum;
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads, 2) attn_fwd_tc_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const AttnGeom g, int nh, int hg, float scale) {
  attn_tc<bf16, false, kAttnWin>(qkv, nullptr, out, bias, mask, nullptr, g,
                                 nh, hg, scale);
}

__global__ void __launch_bounds__(kAttnThreads, 2) attn_bwd_tc_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    bf16* __restrict__ dqkv, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ part,
    const AttnGeom g, int nh, int hg, float scale) {
  attn_tc<bf16, true, kAttnWin>(qkv, dout, dqkv, bias, mask, part, g, nh,
                                hg, scale);
}

__global__ void __launch_bounds__(kAttnF32Threads, kAttnF32FwdBlocks)
    attn_fwd_tf32_kernel(const float* __restrict__ qkv,
                         float* __restrict__ out,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask, const AttnGeom g,
                         int nh, int hg, float scale) {
  attn_tc<float, false, kAttnF32Win>(qkv, nullptr, out, bias, mask,
                                     nullptr, g, nh, hg, scale);
}

__global__ void __launch_bounds__(kAttnF32Threads, kAttnF32BwdBlocks)
    attn_bwd_tf32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ dout,
                         float* __restrict__ dqkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask,
                         float* __restrict__ part, const AttnGeom g, int nh,
                         int hg, float scale) {
  attn_tc<float, true, kAttnF32Win>(qkv, dout, dqkv, bias, mask, part, g,
                                    nh, hg, scale);
}

// Plan (ops/attn_core.py:attn_core_plan): ctas along the tiles, hg heads a
// group, smem bytes.  The launch is refused, not reshaped, when the plan
// and the kernel's needs differ.
template <typename T>
cudaError_t launch_attn_tc(bool bwd, const T* qkv, const T* dout, T* out,
                           const float* bias, const float* mask, float* part,
                           int B, int H, int W, int C, int nh, int wh, int ww,
                           int sh, int sw, int ctas, int hg, int smem,
                           float scale, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  const int max_group = f32 ? kAttnF32Group : kAttnMaxGroup;
  const int win = f32 ? kAttnF32Win : kAttnWin;
  if (wh * ww != kRows || C != nh * kHD || B <= 0 || H <= 0 || W <= 0 ||
      H % wh || W % ww || sh < 0 || sw < 0 || hg < 1 || hg > max_group ||
      nh % hg || nh / hg > 65535 || (bwd && !part))
    return cudaErrorInvalidValue;
  AttnGeom g;
  g.H = H, g.W = W, g.C = C, g.wh = wh, g.ww = ww, g.sh = sh, g.sw = sw;
  g.nWw = W / ww, g.nW = (H / wh) * g.nWw;
  g.windows = B * g.nW;
  g.tiles = (g.windows + win - 1) / win;
  const int need = attn_smem(sizeof(T), bwd ? 4 : 3, hg, win);
  if (smem != need || ctas < 1 || ctas > g.tiles) return cudaErrorInvalidValue;
  const dim3 grid(ctas, nh / hg);
  const int threads = 32 * win * hg;
  cudaError_t err;
#define TULIP_ATTN_LAUNCH(KERNEL, ...)                                   \
  if ((err = prepare_smem(KERNEL, need)) != cudaSuccess) return err;     \
  KERNEL<<<grid, threads, need, stream>>>(__VA_ARGS__)
  if constexpr (f32) {
    if (bwd) {
      TULIP_ATTN_LAUNCH(attn_bwd_tf32_kernel, qkv, dout, out, bias, mask,
                        part, g, nh, hg, scale);
    } else {
      TULIP_ATTN_LAUNCH(attn_fwd_tf32_kernel, qkv, out, bias, mask, g, nh,
                        hg, scale);
    }
  } else {
    if (bwd) {
      TULIP_ATTN_LAUNCH(attn_bwd_tc_kernel, qkv, dout, out, bias, mask, part,
                        g, nh, hg, scale);
    } else {
      TULIP_ATTN_LAUNCH(attn_fwd_tc_kernel, qkv, out, bias, mask, g, nh, hg,
                        scale);
    }
  }
#undef TULIP_ATTN_LAUNCH
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace tulip

// dtype 0 fp32 (split TF32), 1 bf16, under the plan (ctas, hg, smem).
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
    return tulip::tc::launch_attn_tc<float>(
        false, static_cast<const float*>(qkv), nullptr,
        static_cast<float*>(out), b, m, nullptr, B, H, W, C, nh, wh, ww, sh,
        sw, ctas, hg, smem, scale, s);
  if (dtype == 1)
    return tulip::tc::launch_attn_tc<bf16>(
        false, static_cast<const bf16*>(qkv), nullptr, static_cast<bf16*>(out),
        b, m, nullptr, B, H, W, C, nh, wh, ww, sh, sw, ctas, hg, smem, scale,
        s);
  return cudaErrorInvalidValue;
}

// part: (ctas, nh, 16, 16) fp32 d(bias) partials, one row per CTA along
// the tiles (nsplit = the plan's ctas)
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
    return tulip::tc::launch_attn_tc<float>(
        true, static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), b, m, static_cast<float*>(part), B, H, W,
        C, nh, wh, ww, sh, sw, nsplit, hg, smem, scale, s);
  if (dtype == 1)
    return tulip::tc::launch_attn_tc<bf16>(
        true, static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), b, m, static_cast<float*>(part), B, H, W, C,
        nh, wh, ww, sh, sw, nsplit, hg, smem, scale, s);
  return cudaErrorInvalidValue;
}
