// Eval Focus stem: space-to-depth + 3x3 conv + folded BN + SiLU, computed
// as ONE 6x6 stride-2 convolution (padding 2) over the raw image.
//
// Replaces tscd_tpu/ops/pallas/focus_stem.py (_focus_stem_impl ->
// _kernel). The wrapper folds the BN scale into the weights and
// rearranges them to (ky, kx, c, o) tap order, with ky = 2u + dy and
// kx = 2v + dx for the s2d channel (dx*2 + dy)*C + c of the 3x3 kernel.
//
// Layout: x (F, H, W, 3) NHWC, fp32 (or uint8 with bf16 out); w (6, 6, 3, OC) fp32;
// shift (OC) fp32; out (F, OC, H/2, W/2) NCHW, fp32 or bf16, the layout
// every conv after the stem runs in. H and W even, OC a multiple of 8.
//
// The bf16 variant computes what the Pallas kernel computes at
// out_dtype bf16 (focus_stem.py:144-148): the image and the folded
// weights rounded to bf16 (the wrapper rounds the weights; a uint8 pixel
// is exact in bf16, an fp32 one is rounded here as it is read), fp32
// sums, + shift and SiLU in fp32, the result rounded to bf16. A product
// of two bf16 values is exact in fp32, so the kernel and its plain
// version differ only in the order of the sums. It reads uint8 frames
// straight from the loader's upload (no cast pass): 31.85 MB in and
// 340 MB out at the window's shape, 0.111 ms at 3.35 TB/s, which bounds
// it (its 36.7 GFLOP take 0.037 ms at the bf16 tensor-core rate). It
// runs the fp32 kernel's FMA loop on the CUDA cores, so its operations
// (0.548 ms at 67 TFLOP/s) set its pace; a uint8 or rounded pixel is
// converted as it is read, with plain loads in place of cp.async.
//
// Bound at (32, 576, 576, 3) -> 64 channels: 127 MB read and 679 MB
// written (0.24 ms at 3.35 TB/s) against 36.7 GFLOP of fp32 FMA (0.548 ms
// at 67 TFLOP/s), so operations bound it: the kernel has to keep the FMA
// pipes busy, and every other instruction takes one of their slots.
//
// Design, all in fp32 FMA on the CUDA cores (no TF32):
// - Persistent blocks of 256 threads (8 warps), as many as fit on the SMs
//   at once (2 per SM at OC = 64). Each loads the 108 x OC folded weights
//   (27.6 KB at OC = 64) into shared memory once, each channel block's
//   taps contiguous, then walks output tiles (frame, tile row, tile
//   column) with a stride of the grid size.
// - A tile is TH x 32 output pixels for all OC channels, TH = 4 * RG.
//   A thread owns 4 neighbouring output columns of one row and CB = 16
//   (or 8, if OC is not a multiple of 16) channels: 64 accumulators. Each
//   warp takes (row group, channel block) items: 4 rows x 32 columns x CB
//   channels, 8 lanes to a row. RG = max(1, 8 / (OC / CB)) row groups, so
//   at OC = 64 the tile is 8 x 32 and each warp holds one item.
// - The halo of a tile (2TH+4 rows x 68 columns x 3 channels) is copied
//   with 4-byte cp.async, double buffered: tile t+1's halo is in flight
//   while tile t is computed. The copy splits columns by parity and
//   channel into lines of 36 floats, so that the 6 inputs a thread needs
//   for one (ky, c, kx parity) sit at 4 neighbouring addresses and two
//   conflict-free 16-byte loads fetch them; the zero padding is the
//   copy's src-size-0 form.
// - Per (ky, c, parity): 2 x loads, then 3 taps of CB/4 broadcast
//   16-byte weight loads and 4 x CB FMAs: at CB = 16, 14 shared loads to
//   192 FMAs, so the FMAs set the pace.
// - Epilogue: + shift, SiLU with the accurate expf, and per channel one
//   16-byte store of the 4 pixels (8 lanes write 128 contiguous bytes);
//   masked scalar stores at the ragged edge or where W/2 % 4 != 0.
// Registers are capped at 128 a thread by __launch_bounds__(256, 2);
// shared memory per block is 4 * (108 OC + OC + 2 * 3 * (2TH+4) * 72)
// bytes, 62.5 KB at OC = 64. `-Xptxas -v` output is in
// build/kernels/build.log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int CIN = 3;
constexpr int KS = 6;
constexpr int TAPS = KS * KS * CIN;       // 108
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PX = 4;                     // output columns per thread
constexpr int TW = 32;                    // output columns per tile
constexpr int WARP_ROWS = 4;              // output rows per warp item
constexpr int HALO_W = 2 * TW + KS - 2;   // 68 input columns
constexpr int LINE = HALO_W / 2 + 2;      // 36 floats per (c, row, parity)
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Tiles {
  int H, W, H2, W2, O, TH, HR, tiles_x, per_frame, n;
};

__device__ __forceinline__ float pixel(unsigned char v) {
  return static_cast<float>(v);
}

// an fp32 pixel of the bf16 variant, rounded to bf16 as the Pallas kernel
// rounds its input
__device__ __forceinline__ float pixel(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Starts the copy of `tile`'s halo into `dst`: element (c, r, k) of the
// window at input rows iy0.., columns ix0.. lands at
// ((c * HR + r) * 2 + k % 2) * LINE + k / 2. Thread m < 204 copies
// element m = 3k + c of every row, so a warp reads consecutive elements.
// fp32 frames at fp32 go by cp.async; the other variants convert each
// pixel as they read it, with plain loads and stores.
template <typename TIn, bool BF16>
__device__ __forceinline__ void load_halo(float* dst, const TIn* x,
                                          int tile, const Tiles& g) {
  const int m = threadIdx.x;
  if (m >= HALO_W * CIN) return;
  const int f = tile / g.per_frame;
  const int rem = tile - f * g.per_frame;
  const int ty = rem / g.tiles_x, tx = rem - ty * g.tiles_x;
  const int iy0 = 2 * ty * g.TH - 2, ix0 = 2 * tx * TW - 2;
  const int k = m / CIN, c = m - k * CIN;
  const int ix = ix0 + k;
  const bool col_in = ix >= 0 && ix < g.W;
  const long long row = static_cast<long long>(g.W) * CIN;
  long long src = (static_cast<long long>(f) * g.H + iy0) * row + ix * CIN + c;
  float* d = dst + (c * g.HR * 2 + (k & 1)) * LINE + (k >> 1);
#pragma unroll 4
  for (int r = 0; r < g.HR; ++r, src += row, d += 2 * LINE) {
    const int iy = iy0 + r;
    const bool in = col_in && iy >= 0 && iy < g.H;
    if constexpr (std::is_same<TIn, float>::value && !BF16)
      cp_async4(d, in ? x + src : x, in ? 4 : 0);
    else
      *d = in ? pixel(x[src]) : 0.f;
  }
}

template <int CB, typename TIn, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
focus_stem_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift, void* __restrict__ out,
                  Tiles g, int rg) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                         // (O / CB) x TAPS x CB
  float* s_shift = s_w + TAPS * g.O;         // O
  float* s_x = s_shift + g.O;                // 2 halo buffers
  const int buf = CIN * g.HR * 2 * LINE;
  const int plane = g.HR * 2 * LINE;         // one input channel

  // each channel block's taps contiguous, so that weight offsets in the
  // tap loop are constants
  for (int i = threadIdx.x; i < TAPS * g.O; i += THREADS) {
    const int tap = i / g.O, o = i - tap * g.O;
    s_w[((o / CB) * TAPS + tap) * CB + o % CB] = w[i];
  }
  for (int i = threadIdx.x; i < g.O; i += THREADS) s_shift[i] = shift[i];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 7;                    // columns 4q .. 4q+3 of the tile
  const int items = rg * (g.O / CB);

  int tile = blockIdx.x;
  if (tile < g.n) load_halo<TIn, BF16>(s_x, x, tile, g);
  cp_async_commit();
  for (int it = 0; tile < g.n; ++it, tile += gridDim.x) {
    const float* cur = s_x + (it & 1) * buf;
    const int next = tile + gridDim.x;
    if (next < g.n) load_halo<TIn, BF16>(s_x + ((it + 1) & 1) * buf, x, next, g);
    cp_async_commit();                       // possibly empty: keeps the count
    cp_async_wait<1>();                      // this tile's halo has landed
    __syncthreads();

    const int f = tile / g.per_frame;
    const int rem = tile - f * g.per_frame;
    const int ty = rem / g.tiles_x, tx = rem - ty * g.tiles_x;
    for (int item = warp; item < items; item += WARPS) {
      const int cb = item / rg;
      const int lr = (item - cb * rg) * WARP_ROWS + (lane >> 3);
      const float* xs = cur + 4 * lr * LINE + 4 * q;   // row 2*lr, parity 0
      const float* ws = s_w + cb * TAPS * CB;
      float acc[PX][CB];                     // starts at the shift
#pragma unroll
      for (int o = 0; o < CB; ++o) {
        const float s = s_shift[cb * CB + o];
#pragma unroll
        for (int i = 0; i < PX; ++i) acc[i][o] = s;
      }

#pragma unroll 1
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float* xr = xs + c * plane + (2 * ky + p) * LINE;
            const float4 x0 = *reinterpret_cast<const float4*>(xr);
            const float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
            const float xv[6] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y};
#pragma unroll
            for (int a = 0; a < 3; ++a) {            // kx = 2a + p
              const float* wr = ws + ((ky * KS + 2 * a + p) * CIN + c) * CB;
#pragma unroll
              for (int o4 = 0; o4 < CB / 4; ++o4) {
                const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * o4);
#pragma unroll
                for (int i = 0; i < PX; ++i) {
                  acc[i][4 * o4 + 0] = fmaf(xv[i + a], wv.x, acc[i][4 * o4 + 0]);
                  acc[i][4 * o4 + 1] = fmaf(xv[i + a], wv.y, acc[i][4 * o4 + 1]);
                  acc[i][4 * o4 + 2] = fmaf(xv[i + a], wv.z, acc[i][4 * o4 + 2]);
                  acc[i][4 * o4 + 3] = fmaf(xv[i + a], wv.w, acc[i][4 * o4 + 3]);
                }
              }
            }
          }
        }
      }

      const int oy = ty * g.TH + lr, ox = tx * TW + PX * q;
      if (oy < g.H2 && ox < g.W2) {
        const bool vec = (g.W2 & 3) == 0;    // then ox + 3 < W2 as well
#pragma unroll
        for (int o = 0; o < CB; ++o) {
          float y[PX];
#pragma unroll
          for (int i = 0; i < PX; ++i) {
            const float v = acc[i][o];
            y[i] = __fdividef(v, 1.f + expf(-v));
          }
          const size_t at = ((static_cast<size_t>(f) * g.O + cb * CB + o) * g.H2 + oy)
                                * g.W2 + ox;
          if constexpr (BF16) {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + at;
            if (vec) {                       // 4 pixels, one 8-byte store
              const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
              const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
              uint2 u;
              u.x = *reinterpret_cast<const unsigned*>(&lo);
              u.y = *reinterpret_cast<const unsigned*>(&hi);
              *reinterpret_cast<uint2*>(dst) = u;
            } else {
#pragma unroll
              for (int i = 0; i < PX; ++i)
                if (ox + i < g.W2) dst[i] = __float2bfloat16_rn(y[i]);
            }
          } else {
            float* dst = static_cast<float*>(out) + at;
            if (vec) {
              *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
            } else {
#pragma unroll
              for (int i = 0; i < PX; ++i)
                if (ox + i < g.W2) dst[i] = y[i];
            }
          }
        }
      }
    }
    __syncthreads();                         // before this buffer is refilled
  }
  cp_async_wait<0>();
}

// The kernel's shared-memory limit, raised to the card's opt-in maximum
// once a device and kept.
template <int CB, typename TIn, bool BF16>
cudaError_t configure(int dev) {
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    int optin = 0;
    status[dev] = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (status[dev] == cudaSuccess)
      status[dev] = cudaFuncSetAttribute(focus_stem_kernel<CB, TIn, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  });
  return status[dev];
}

template <int CB, typename TIn, bool BF16>
int launch(const TIn* x, const float* w, const float* shift, void* out,
           int F, int H, int W, int OC, cudaStream_t stream) {
  const int rg = (OC / CB) >= WARPS ? 1 : WARPS / (OC / CB);
  Tiles g;
  g.H = H; g.W = W; g.H2 = H / 2; g.W2 = W / 2; g.O = OC;
  g.TH = WARP_ROWS * rg;
  g.HR = 2 * g.TH + KS - 2;
  g.tiles_x = (g.W2 + TW - 1) / TW;
  g.per_frame = ((g.H2 + g.TH - 1) / g.TH) * g.tiles_x;
  g.n = F * g.per_frame;
  const size_t smem = sizeof(float) * (TAPS * OC + OC + 2 * CIN * g.HR * 2 * LINE);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = configure<CB, TIn, BF16>(dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, focus_stem_kernel<CB, TIn, BF16>, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = g.n < per_sm * sms ? g.n : per_sm * sms;
  focus_stem_kernel<CB, TIn, BF16><<<grid, THREADS, smem, stream>>>(x, w, shift, out, g, rg);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn, bool BF16>
int launch_oc(const void* x, const float* w, const float* shift, void* out,
              int F, int H, int W, int OC, cudaStream_t stream) {
  const auto xs = static_cast<const TIn*>(x);
  return OC % 16 == 0 ? launch<16, TIn, BF16>(xs, w, shift, out, F, H, W, OC, stream)
                      : launch<8, TIn, BF16>(xs, w, shift, out, F, H, W, OC, stream);
}

}  // namespace

// out_bf16: out is bf16 (else fp32); x_u8: x is uint8 (else fp32), with
// bf16 out only.
extern "C" int tscd_focus_stem(const void* x, const void* w, const void* shift,
                               void* out, int F, int H, int W, int C, int OC,
                               int x_u8, int out_bf16, void* stream) {
  if (C != CIN || OC < 8 || OC % 8 != 0 || H < 2 || W < 2 || H % 2 || W % 2 ||
      F < 1 || (x_u8 && !out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto ws = static_cast<const float*>(w);
  const auto ss = static_cast<const float*>(shift);
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_u8) return launch_oc<unsigned char, true>(x, ws, ss, out, F, H, W, OC, st);
  return out_bf16 ? launch_oc<float, true>(x, ws, ss, out, F, H, W, OC, st)
                  : launch_oc<float, false>(x, ws, ss, out, F, H, W, OC, st);
}
