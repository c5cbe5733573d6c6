// Eval Focus stem: space-to-depth + 3x3 conv + folded BN + SiLU, computed
// as ONE 6x6 stride-2 convolution (padding 2) over the raw image.
//
// Replaces tscd_tpu/ops/pallas/focus_stem.py (_focus_stem_impl ->
// _kernel). The wrapper folds the BN scale into the weights and
// rearranges them to (ky, kx, c, o) tap order, with ky = 2u + dy and
// kx = 2v + dx for the s2d channel (dx*2 + dy)*C + c of the 3x3 kernel.
//
// Layout: x (F, H, W, 3) fp32 NHWC; w (6, 6, 3, OC); shift (OC);
// out (F, H/2, W/2, OC), which is channels_last for a (F, OC, H/2, W/2)
// tensor. OC must be a multiple of 8.
//
// Design: a direct convolution. A block computes a tile of 8 x 32 output
// pixels for every output channel. The halo tile of the image it needs
// (20 rows x 68 columns x 3 channels) and all 108 x OC folded weights sit
// in shared memory; each thread owns one output pixel and runs the 108
// taps for 8 output channels at a time, then adds the shift and applies
// SiLU before the store. C_in = 3 gives a generic conv only 3 values of
// reduction per tap, which is why the stem has a kernel of its own.
// Bound at (32, 576, 576, 3) -> 64 channels: 127 MB read, 679 MB written
// (0.24 ms at 3.35 TB/s) and 36.7 GFLOP of fp32 FMA (0.55 ms at
// 67 TFLOP/s), so operations bound it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int CIN = 3;
constexpr int KS = 6;
constexpr int IN_H = 2 * TH + KS - 2;   // 20 input rows
constexpr int IN_W = 2 * TW + KS - 2;   // 68 input columns
constexpr int ROW = IN_W * CIN;         // floats per halo row
constexpr int TAPS = KS * KS * CIN;     // 108
constexpr int OCB = 8;                  // output channels per pass

__global__ void __launch_bounds__(TH * TW)
focus_stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift, float* __restrict__ out,
                  int H, int W, int OC) {
  extern __shared__ float smem[];
  float* s_x = smem;                    // IN_H x ROW
  float* s_w = s_x + IN_H * ROW;        // TAPS x OC
  float* s_shift = s_w + TAPS * OC;     // OC

  const int H2 = H / 2, W2 = W / 2;
  const int f = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = 2 * oy0 - 2, ix0 = 2 * ox0 - 2;
  const int tid = threadIdx.y * TW + threadIdx.x;
  constexpr int NT = TH * TW;

  for (int idx = tid; idx < TAPS * OC; idx += NT) s_w[idx] = w[idx];
  for (int idx = tid; idx < OC; idx += NT) s_shift[idx] = shift[idx];
  const float* xf = x + static_cast<size_t>(f) * H * W * CIN;
  for (int idx = tid; idx < IN_H * ROW; idx += NT) {
    const int r = idx / ROW, col = idx - r * ROW;
    const int iy = iy0 + r, ix = ix0 + col / CIN;
    float val = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      val = xf[(static_cast<size_t>(iy) * W + ix0) * CIN + col];
    s_x[idx] = val;
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y, ox = ox0 + threadIdx.x;
  if (oy >= H2 || ox >= W2) return;
  const float* px = s_x + 2 * threadIdx.y * ROW + 2 * threadIdx.x * CIN;
  float* po = out + ((static_cast<size_t>(f) * H2 + oy) * W2 + ox) * OC;
  for (int oc0 = 0; oc0 < OC; oc0 += OCB) {
    float acc[OCB];
#pragma unroll
    for (int o = 0; o < OCB; ++o) acc[o] = 0.f;
    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int t = 0; t < KS * CIN; ++t) {   // (kx, c) along the halo row
        const float xv = px[ky * ROW + t];
        const float4* wr = reinterpret_cast<const float4*>(
            s_w + (ky * KS * CIN + t) * OC + oc0);
        const float4 w0 = wr[0], w1 = wr[1];
        acc[0] = fmaf(xv, w0.x, acc[0]);
        acc[1] = fmaf(xv, w0.y, acc[1]);
        acc[2] = fmaf(xv, w0.z, acc[2]);
        acc[3] = fmaf(xv, w0.w, acc[3]);
        acc[4] = fmaf(xv, w1.x, acc[4]);
        acc[5] = fmaf(xv, w1.y, acc[5]);
        acc[6] = fmaf(xv, w1.z, acc[6]);
        acc[7] = fmaf(xv, w1.w, acc[7]);
      }
    }
    float y[OCB];
#pragma unroll
    for (int o = 0; o < OCB; ++o) {
      const float v = acc[o] + s_shift[oc0 + o];
      y[o] = v / (1.f + expf(-v));
    }
    float4* dst = reinterpret_cast<float4*>(po + oc0);
    dst[0] = make_float4(y[0], y[1], y[2], y[3]);
    dst[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
}

}  // namespace

extern "C" int tscd_focus_stem(const void* x, const void* w, const void* shift,
                               void* out, int F, int H, int W, int C, int OC,
                               void* stream) {
  if (C != CIN || OC < OCB || OC % OCB != 0 || H % 2 || W % 2 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (IN_H * ROW + TAPS * OC + OC);
  cudaError_t err = cudaFuncSetAttribute(
      focus_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TW, TH);
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, F);
  focus_stem_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(shift), static_cast<float*>(out), H, W, OC);
  return static_cast<int>(cudaGetLastError());
}
