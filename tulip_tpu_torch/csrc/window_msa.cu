// Fused shifted-window MSA half-block: out = x + proj(MSA(LN1(x))).
//
// Replaces: tulip_tpu/ops/pallas/window_msa.py:_kernel_masked_nat (heads
// <= 8) and window_msa.py:_kernel (heads > 8), and their layout twins
// window_msa.py:_kernel_masked (heads <= 8 on the grouped window-major
// layout) and window_msa.py:_kernel_nat (heads > 8 on natural row strips).
// One kernel serves all four: the TPU kernels differ only in layout and
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
// Bound on the H100: each window does 2*16*C*4C FLOPs of qkv/proj products
// against 4C^2 weights, i.e. 16 MACs per weight element read, plus 64*C
// bytes of activations from HBM; far below the tensor-core roofline.  This
// simple design runs fp32 FMA on the CUDA cores.  Measured (PERF.md): at
// C <= 192 the product loop's shared-memory loads (4 per 4 FMAs) bound it;
// at C >= 384 there are only 16-512 windows per launch (batch 1-8) and
// each CTA waits on one weight tile at a time from HBM (1.2-4.7 MB of bf16
// weights per block).
// Design: one CTA per window, a loop over heads; the LN output and the
// concatenated head outputs stay in shared memory ((2*16*C) fp32, 96 KB at
// C = 768), weights stream in 64x32 tiles; q/k/v, logits and probabilities
// never leave the CTA.  Tensor cores (wgmma), weight prefetch and several
// windows per CTA are later work.
#include "common.cuh"

namespace tulip {

constexpr int kHeadDim = 32;
constexpr int kQKVStride = 3 * kHeadDim + 1;   // padded: conflict-free k reads

template <typename T>
__global__ void __launch_bounds__(kThreads) window_msa_kernel(
    const T* __restrict__ x, T* __restrict__ out, const T* __restrict__ lnw,
    const T* __restrict__ lnb, const T* __restrict__ wqkv,
    const T* __restrict__ bqkv, const T* __restrict__ wproj,
    const T* __restrict__ bproj, const float* __restrict__ bias,
    const float* __restrict__ mask, int H, int W, int C, int nh, int wh,
    int ww, int sh, int sw, float scale, float eps) {
  extern __shared__ float smem[];
  long long* toff = reinterpret_cast<long long*>(smem);   // kRows offsets
  float* xn = smem + 2 * kRows;                  // [16][C] LN1(x)
  float* ao = xn + kRows * C;                    // [16][C] head outputs
  float* qkv = ao + kRows * C;                   // [16][97] one head's q|k|v
  float* pr = qkv + kRows * kQKVStride;          // [16][16] probabilities
  float* wtile = pr + kRows * kRows;

  const int tid = threadIdx.x;
  const int nWw = W / ww, nW = (H / wh) * nWw;
  const int b = blockIdx.x / nW, win = blockIdx.x % nW;
  const int wi = win / nWw, wj = win % nWw;

  if (tid < kRows) {
    const int row = (wi * wh + tid / ww + sh) % H;
    const int col = (wj * ww + tid % ww + sw) % W;
    toff[tid] = ((long long)(b * H + row) * W + col) * C;
  }
  __syncthreads();
  for (int i = tid; i < kRows * C; i += kThreads)
    xn[i] = to_f(x[toff[i / C] + i % C]);
  __syncthreads();
  layer_norm_rows<T>(xn, C, C, lnw, lnb, eps);

  const int li = tid >> 4, lj = tid & 15;   // logits / PV thread mapping
  for (int h = 0; h < nh; ++h) {
    // q|k|v of head h: weight rows h*32 + d, C + h*32 + d, 2C + h*32 + d
    const RowMap qkv_rows{h * kHeadDim, kHeadDim, C};
    gemm_rows<T>(xn, C, C, wqkv, C, qkv_rows, 3 * kHeadDim, wtile,
                 [&](int r, int n, float v) {
                   const float b = to_f(bqkv[qkv_rows(n)]);
                   qkv[r * kQKVStride + n] = round_to<T>(v + b);
                 });
    __syncthreads();
    // logits and softmax: thread (li, lj); a row's 16 lanes share a warp
    const float* q = qkv + li * kQKVStride;
    const float* k = qkv + lj * kQKVStride + kHeadDim;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) s += q[d] * k[d];
    s = s * scale + bias[(h * kRows + li) * kRows + lj];
    if (mask) s += mask[(win * kRows + li) * kRows + lj];
    float m = s;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = expf(s - m);
    float sum = e;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    pr[li * kRows + lj] = round_to<T>(e / sum);
    __syncthreads();
    // PV: thread (li, lj) computes head dims lj and lj + 16 of token li
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = lj + 16 * half;
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        o += pr[li * kRows + j] * qkv[j * kQKVStride + 2 * kHeadDim + d];
      ao[li * C + h * kHeadDim + d] = round_to<T>(o);
    }
  }
  // proj + bias + residual, written back to the tokens' own positions
  gemm_rows<T>(ao, C, C, wproj, C, identity_rows(), C, wtile,
               [&](int r, int n, float v) {
                 const long long off = toff[r] + n;
                 out[off] = from_f<T>(v + to_f(bproj[n]) + to_f(x[off]));
               });
}

template <typename T>
cudaError_t launch_window_msa(const void* x, void* out, const void* lnw,
                              const void* lnb, const void* wqkv,
                              const void* bqkv, const void* wproj,
                              const void* bproj, const void* bias,
                              const void* mask, int B, int H, int W, int C,
                              int nh, int wh, int ww, int sh, int sw,
                              float scale, float eps, cudaStream_t stream) {
  if (wh * ww != kRows || C != nh * kHeadDim || C % kKC || H % wh || W % ww)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * kRows + 2 * kRows * C +
                                       kRows * kQKVStride + kRows * kRows +
                                       kWTileFloats);
  cudaError_t err = prepare_smem(window_msa_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = B * (H / wh) * (W / ww);
  window_msa_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<const T*>(wqkv), static_cast<const T*>(bqkv),
      static_cast<const T*>(wproj), static_cast<const T*>(bproj),
      static_cast<const float*>(bias), static_cast<const float*>(mask), H, W,
      C, nh, wh, ww, sh, sw, scale, eps);
  return cudaGetLastError();
}

}  // namespace tulip

extern "C" int tulip_window_msa(int dtype, const void* x, void* out,
                                const void* lnw, const void* lnb,
                                const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj,
                                const void* bias, const void* mask, int B,
                                int H, int W, int C, int nh, int wh, int ww,
                                int sh, int sw, float scale, float eps,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tulip::launch_window_msa<float>(x, out, lnw, lnb, wqkv, bqkv, wproj,
                                           bproj, bias, mask, B, H, W, C, nh,
                                           wh, ww, sh, sw, scale, eps, s);
  if (dtype == 1)
    return tulip::launch_window_msa<__nv_bfloat16>(
        x, out, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, mask, B, H, W, C,
        nh, wh, ww, sh, sw, scale, eps, s);
  return cudaErrorInvalidValue;
}

// xg: (windows, 16, C) window-major tokens (the (B, nG, 128, C) grouped
// layout viewed flat), windows % nW == 0; mask (nW, 16, 16) or null
extern "C" int tulip_window_msa_grouped(
    int dtype, const void* xg, void* out, const void* lnw, const void* lnb,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    const void* bias, const void* mask, int windows, int nW, int C, int nh,
    float scale, float eps, void* stream) {
  if (nW <= 0 || windows <= 0 || windows % nW) return cudaErrorInvalidValue;
  return tulip_window_msa(dtype, xg, out, lnw, lnb, wqkv, bqkv, wproj, bproj,
                          bias, mask, windows / nW, nW, tulip::kRows, C, nh, 1,
                          tulip::kRows, 0, 0, scale, eps, stream);
}

extern "C" const char* tulip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
