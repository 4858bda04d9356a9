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
// kernel); dS kept fp32 for d(B) and rounded before dq / dk; o and dqkv
// rounded once.  The TPU layout (128-token groups, -1e9 block-diagonal
// mask, head-block-diagonal expansion, natural-token permutation) was an
// MXU workaround and is not carried over; its shared row max across heads
// (attn_core.py:130) is replaced by an exact per-head max.
//
// Bound on the H100: 4 x 16 x 16 x 32 MACs per window and head against
// 3 x 16 x 32 loaded values (forward) or 4 x 16 x 32 + 3 x 16 x 32 stored
// (backward): a few FMAs per byte, so HBM traffic and latency bound it.
// Design: one CTA of 256 threads per head and split of the windows; thread
// (i, j) owns logit (i, j), and a row's 16 lanes reduce by shuffles inside
// a half-warp.  The CTA walks its windows (p, p + P, p + 2P, ...) keeping
// its d(B) partial in one register per thread, and writes it once to
// part[p][h][i][j]; tulip_colsum sums the P partials in a fixed order
// (deterministic, no atomics; P * nh * 256 floats, 2 MB at stage 0).
#include "common.cuh"

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

template <typename T>
cudaError_t launch_attn_fwd(const void* qkv, void* out, const void* bias,
                            const void* mask, int B, int H, int W, int C,
                            int nh, int wh, int ww, int sh, int sw,
                            float scale, cudaStream_t stream) {
  WindowGeom geo;
  cudaError_t err = make_geom(H, W, C, nh, wh, ww, sh, sw, &geo);
  if (err != cudaSuccess) return err;
  const int total = B * geo.nWin;
  const dim3 grid(nh, min(total, 65535));
  attn_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out),
      static_cast<const float*>(bias), static_cast<const float*>(mask), geo,
      total, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attn_bwd(const void* qkv, const void* dout, void* dqkv,
                            const void* bias, const void* mask, void* part,
                            int B, int H, int W, int C, int nh, int wh,
                            int ww, int sh, int sw, int nsplit, float scale,
                            cudaStream_t stream) {
  WindowGeom geo;
  cudaError_t err = make_geom(H, W, C, nh, wh, ww, sh, sw, &geo);
  if (err != cudaSuccess) return err;
  const int total = B * geo.nWin;
  if (nsplit < 1 || nsplit > total || nsplit > 65535)
    return cudaErrorInvalidValue;
  attn_bwd_kernel<T><<<dim3(nh, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(part), geo, total,
      scale);
  return cudaGetLastError();
}

}  // namespace tulip

extern "C" int tulip_attn_fwd(int dtype, const void* qkv, void* out,
                              const void* bias, const void* mask, int B,
                              int H, int W, int C, int nh, int wh, int ww,
                              int sh, int sw, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::launch_attn_fwd<float>(qkv, out, bias, mask, B, H, W, C,
                                         nh, wh, ww, sh, sw, scale, s);
  if (dtype == 1)
    return tulip::launch_attn_fwd<__nv_bfloat16>(
        qkv, out, bias, mask, B, H, W, C, nh, wh, ww, sh, sw, scale, s);
  return cudaErrorInvalidValue;
}

// part: (nsplit, nh, 16, 16) fp32 per-split d(bias) partials
extern "C" int tulip_attn_bwd(int dtype, const void* qkv, const void* dout,
                              void* dqkv, const void* bias, const void* mask,
                              void* part, int B, int H, int W, int C, int nh,
                              int wh, int ww, int sh, int sw, int nsplit,
                              float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::launch_attn_bwd<float>(qkv, dout, dqkv, bias, mask, part,
                                         B, H, W, C, nh, wh, ww, sh, sw,
                                         nsplit, scale, s);
  if (dtype == 1)
    return tulip::launch_attn_bwd<__nv_bfloat16>(
        qkv, dout, dqkv, bias, mask, part, B, H, W, C, nh, wh, ww, sh, sw,
        nsplit, scale, s);
  return cudaErrorInvalidValue;
}
