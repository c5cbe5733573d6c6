// int8 (w8a8) convolution for the int8 serving mode: the quantize pass,
// its abs-max pass and an implicit-GEMM conv on the int8 tensor cores.
//
// Replaces no Pallas kernel. It replaces the XLA int8 conv of
// tscd_tpu/models/blocks.py:347-353 (BaseConv._int8_forward): activations
// quantized to int8 by `clip(round(x / x_scale), -127, 127)`, weights
// (BN folded, one scale an output channel) by `round(w / s_w)`, the conv
// summed in int32, then `float(acc) * (s_x * s_w)[c] + b[c]`, cast to the
// model's dtype, the activation. PyTorch has no int8 convolution on CUDA.
//
// Three kernels:
// 1. int8_absmax: max |x| over a whole tensor (the dynamic scale's
//    reduction, one pass): a grid-stride loop of 16-byte loads, a warp and
//    block reduction, one atomicMax a block on the float's bits (a
//    non-negative float orders as its bits do). The entry point zeroes the
//    result first. The scale s_x = max(amax, 1e-8) / 127 is formed by each
//    reader, on the device: no host read.
// 2. int8_quantize: NCHW fp32 or bf16 (F, C, H, W) -> NHWC int8
//    (F, H, W, Cp), Cp = C rounded up to 32 (the padding is 0, so a 32-deep
//    k-step of the conv never straddles two taps). A block transposes 32
//    channels x 64 pixels through shared memory: coalesced reads along the
//    pixels, 4-byte writes along the channels. The divisor is read from
//    device memory: the dynamic scale (mode 0), a per-channel vector
//    (mode 1, the static x_scale) or a per-frame vector (mode 2: weights,
//    F = C_out, one s_w a row). `__fdiv_rn` (a true IEEE division, as
//    JAX's `xf / x_scale`) and `rintf` (half to even, as jnp.round). The
//    weights' clip cannot bind: |w| / s_w <= 127 (1 + 2^-23) rounds to 127.
// 3. int8_conv_mma<BN>: implicit GEMM, M = F Ho Wo output pixels, N =
//    C_out, K = k k Cp in tap-major, channel-minor order (the packed
//    weights are (C_out, k, k, Cp)); no unfolded copy. A block of 8 warps
//    computes a 128 x BN tile (BN 128, or 64 for C_out <= 64), a warp a
//    64 x BN/4 tile, with mma.sync.m16n8k32 s8 x s8 -> s32 on fragments
//    from ldmatrix. K goes in steps of 32 through a 4-stage cp.async ring
//    in shared memory (16-byte copies; a tap outside the map or a row past
//    M is zero-filled by the copy's src-size 0). The rows' 16-byte halves
//    are swapped every 4 rows so that ldmatrix reads no bank twice.
//    Epilogue, in registers, in JAX's order (blocks.py:352-353):
//    __int2float_rn(acc), x __fmul_rn(s_x, s_w[c]) (the product formed
//    once, in fp32), + b[c] (__fmul_rn / __fadd_rn: no FMA), cast to the
//    output dtype, the activation on that value (SiLU x / (1 + exp(-x)),
//    ReLU, leaky ReLU 0.1 or none), cast again, written NCHW. With
//    out_dtype 2 it writes the int32 sums instead (for checks).
//
// Bound (TSCD-Large window, F = 32, 576 px): the 126 (dynamic) / 133
// (static) quantized convs do 2.37 / 2.50 T multiply-adds, 2.40 / 2.53 ms
// at 1979 TOP/s; their int8 operands and NCHW outputs are far fewer bytes
// (a 1x1 conv at C 128 does 256 operations a byte of input). The abs-max
// and quantize passes are bytes-bound (one read of x; one read of x, a
// quarter (fp32) or half (bf16) of it written as int8).
//
// All arithmetic is IEEE: do not build this file with --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QPIX = 64;       // pixels of a quantize block
constexpr int QCH = 32;        // channels of a quantize block
constexpr int BM = 128;        // output pixels of a conv block
constexpr int BK = 32;         // K of a stage (one mma k-step)
constexpr int STAGES = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float dynamic_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

// ---------------------------------------------------------------- abs max

__device__ __forceinline__ float absmax4(float m, uint4 v, const float*) {
  m = fmaxf(m, fabsf(__uint_as_float(v.x)));
  m = fmaxf(m, fabsf(__uint_as_float(v.y)));
  m = fmaxf(m, fabsf(__uint_as_float(v.z)));
  return fmaxf(m, fabsf(__uint_as_float(v.w)));
}

__device__ __forceinline__ float absmax4(float m, uint4 v, const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m = fmaxf(m, fabsf(__uint_as_float(w[i] << 16)));
    m = fmaxf(m, fabsf(__uint_as_float(w[i] & 0xffff0000u)));
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_absmax(const T* __restrict__ x, long long n,
                                                       unsigned int* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  float m = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long nv = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < nv;
         i += stride)
      m = absmax4(m, __ldg(xv + i), x);
    head = nv * VEC;
  }
  for (long long i = head + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride)
    m = fmaxf(m, fabsf(load_f(x + i)));
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_max[0];
    for (int i = 1; i < THREADS / 32; ++i) b = fmaxf(b, warp_max[i]);
    atomicMax(out, __float_as_uint(b));
  }
}

// --------------------------------------------------------------- quantize

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_quantize(const T* __restrict__ x, int C, int HW, int Cp, const float* __restrict__ scale,
                  int mode, int8_t* __restrict__ out) {
  // 64 pixels x 8 words (32 channels) a block; a row of 9 words, so that
  // 32 consecutive pixels' words fall on 32 banks
  __shared__ uint32_t tile[QPIX * 9];
  const int f = blockIdx.z, c0 = blockIdx.y * QCH, p0 = blockIdx.x * QPIX;
  const int p = threadIdx.x & (QPIX - 1), g = threadIdx.x >> 6;   // g: channels 8 g .. 8 g + 7
  const T* xf = x + static_cast<long long>(f) * C * HW;
  float s = 0.0f;
  if (mode == 0) s = dynamic_scale(scale[0]);
  if (mode == 2) s = scale[f];
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + 8 * g + i;
    int q = 0;
    if (c < C && p0 + p < HW) {
      const float v = load_f(xf + static_cast<long long>(c) * HW + p0 + p);
      const float r = rintf(__fdiv_rn(v, mode == 1 ? scale[c] : s));
      q = static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    word[i >> 2] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i & 3));
  }
  tile[p * 9 + 2 * g] = word[0];
  tile[p * 9 + 2 * g + 1] = word[1];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = threadIdx.x + k * THREADS, pp = w >> 3, j = w & 7;
    if (p0 + pp < HW)
      *reinterpret_cast<uint32_t*>(out + (static_cast<long long>(f) * HW + p0 + pp) * Cp + c0 +
                                   4 * j) = tile[pp * 9 + j];
  }
}

// ------------------------------------------------------------------- conv

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of row r's 16-byte half h in a stage of 32-byte rows
__device__ __forceinline__ int swz(int r, int h) { return r * 32 + ((h ^ ((r >> 2) & 1)) << 4); }

struct ConvArgs {
  const int8_t* x;        // (F, H, W, Cp)
  const int8_t* w;        // (N, k, k, Cp)
  const float* sx;        // mode 0: the abs max; mode 1: s_x
  const float* sw;        // (N,)
  const float* bias;      // (N,)
  void* out;              // (F, N, Ho, Wo)
  int F, H, W, Cp, N, k, stride, pad, Ho, Wo;
  int sx_mode, act, out_dtype;   // out_dtype 0 fp32, 1 bf16, 2 int32 sums
};

__device__ __forceinline__ float activation(float y, int act) {
  switch (act) {
    case 1: return y / (1.0f + expf(-y));
    case 2: return y > 0.0f ? y : 0.0f;
    case 3: return y > 0.0f ? y : y * 0.1f;
    default: return y;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS) int8_conv_mma(ConvArgs a) {
  constexpr int WN = BN / 4;        // columns of a warp
  constexpr int MI = 4, NI = WN / 8;
  __shared__ __align__(128) int8_t As[STAGES][BM * BK];
  __shared__ __align__(128) int8_t Bs[STAGES][BN * BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n_tiles = (a.N + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int HoWo = a.Ho * a.Wo;
  const long long M = static_cast<long long>(a.F) * HoWo;
  const int K = a.k * a.k * a.Cp, nk = K / BK, cpc = a.Cp / BK;

  // this thread's copies: A row tid / 2 (an output pixel), half tid % 2;
  // B row tid / 2 (an output channel) where tid / 2 < BN
  const int lrow = tid >> 1, lh = tid & 1;
  const long long m = m0 + lrow;
  const bool m_ok = m < M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xbase = a.x;
  if (m_ok) {
    const int f = static_cast<int>(m / HoWo), rem = static_cast<int>(m % HoWo);
    iy0 = (rem / a.Wo) * a.stride - a.pad;
    ix0 = (rem % a.Wo) * a.stride - a.pad;
    xbase = a.x + static_cast<long long>(f) * a.H * a.W * a.Cp;
  }
  const bool b_row = lrow < BN;
  const bool n_ok = b_row && n0 + lrow < a.N;
  const int8_t* wrow = a.w + static_cast<long long>(n_ok ? n0 + lrow : 0) * K + lh * 16;
  int ld_cc = 0, ld_kx = 0, ld_ky = 0;   // the next k-step's channel chunk and tap

  auto load_stage = [&](int stage, int kc) {
    const int iy = iy0 + ld_ky, ix = ix0 + ld_kx;
    const bool ok = m_ok && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
    const int8_t* src =
        ok ? xbase + (static_cast<long long>(iy) * a.W + ix) * a.Cp + ld_cc * BK + lh * 16 : a.x;
    cp_async16(smem_addr(&As[stage][swz(lrow, lh)]), src, ok);
    if (b_row)
      cp_async16(smem_addr(&Bs[stage][swz(lrow, lh)]), n_ok ? wrow + kc * BK : a.w, n_ok);
    if (++ld_cc == cpc) {
      ld_cc = 0;
      if (++ld_kx == a.k) {
        ld_kx = 0;
        ++ld_ky;
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix rows of this lane: A matrices (rows 0-7 | 8-15) x (half 0 | 1),
  // B matrices (n 0-7, half 0 | 1), (n 8-15, half 0 | 1)
  const int lr = lane & 7, lm = lane >> 3;
  const int a_row = wm * 64 + (lm & 1) * 8 + lr, a_half = lm >> 1;
  const int b_row0 = wn * WN + (lm >> 1) * 8 + lr, b_half = lm & 1;

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kc + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();

    const int st = kc % STAGES;
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = a_row + i * 16;
      ldmatrix_x4(smem_addr(&As[st][swz(r, a_half)]), af[i][0], af[i][1], af[i][2], af[i][3]);
    }
    uint32_t bf[NI][2];
#pragma unroll
    for (int j = 0; j < NI; j += 2) {
      const int r = b_row0 + j * 8;
      ldmatrix_x4(smem_addr(&Bs[st][swz(r, b_half)]), bf[j][0], bf[j][1], bf[j + 1][0],
                  bf[j + 1][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
  }
  cp_async_wait<0>();

  // epilogue: lane holds rows g, g + 8 and columns 2 t, 2 t + 1 of each tile
  const int g = lane >> 2, t = lane & 3;
  const float s_x = a.sx_mode == 0 ? dynamic_scale(a.sx[0]) : a.sx[0];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + wm * 64 + i * 16 + g + half * 8;
      if (mm >= M) continue;
      const int f = static_cast<int>(mm / HoWo), rem = static_cast<int>(mm % HoWo);
      const long long obase = static_cast<long long>(f) * a.N * HoWo + rem;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * t + e;
          if (n >= a.N) continue;
          const int v = acc[i][j][half * 2 + e];
          const long long o = obase + static_cast<long long>(n) * HoWo;
          if (a.out_dtype == 2) {
            static_cast<int*>(a.out)[o] = v;
            continue;
          }
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(v), __fmul_rn(s_x, a.sw[n])),
                                    a.bias[n]);
          if (a.out_dtype == 0) {
            static_cast<float*>(a.out)[o] = activation(y, a.act);
          } else {
            const float yb = __bfloat162float(__float2bfloat16_rn(y));
            static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(activation(yb, a.act));
          }
        }
      }
    }
  }
}

}  // namespace

// max |x| of n elements (dtype 0 fp32, 1 bf16) into out[0] (fp32)
extern "C" int tscd_int8_absmax(const void* x, long long n, int dtype, void* out, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = static_cast<long long>(THREADS) * (dtype ? 8 : 4);
  const int blocks = static_cast<int>((n + per - 1) / per < 132 * 8 ? (n + per - 1) / per : 132 * 8);
  auto o = static_cast<unsigned int*>(out);
  if (dtype)
    int8_absmax<<<blocks, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), n, o);
  else
    int8_absmax<<<blocks, THREADS, 0, st>>>(static_cast<const float*>(x), n, o);
  return static_cast<int>(cudaGetLastError());
}

// x (F, C, H, W) (dtype 0 fp32, 1 bf16) -> out (F, H, W, Cp) int8; scale by
// mode: 0 the abs max (s = max(amax, 1e-8) / 127), 1 (C,), 2 (F,)
extern "C" int tscd_int8_quantize(const void* x, int dtype, int F, int C, int H, int W, int Cp,
                                  const void* scale, int mode, void* out, void* stream) {
  if (F <= 0 || F > 65535 || C <= 0 || H <= 0 || W <= 0 || Cp % QCH || Cp < C ||
      mode < 0 || mode > 2 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const dim3 grid((HW + QPIX - 1) / QPIX, Cp / QCH, F);
  const auto s = static_cast<const float*>(scale);
  const auto o = static_cast<int8_t*>(out);
  if (dtype)
    int8_quantize<<<grid, THREADS, 0, st>>>(static_cast<const __nv_bfloat16*>(x), C, HW, Cp, s,
                                           mode, o);
  else
    int8_quantize<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), C, HW, Cp, s, mode, o);
  return static_cast<int>(cudaGetLastError());
}

// out (F, N, Ho, Wo) = act(float(conv(x, w)) * (s_x * s_w) + bias), or the
// int32 sums with out_dtype 2; sx_mode 0: sx is the abs max, 1: s_x
extern "C" int tscd_int8_conv(const void* x, const void* w, const void* sx, const void* sw,
                              const void* bias, void* out, int F, int H, int W, int Cp, int N,
                              int k, int stride, int pad, int sx_mode, int act, int out_dtype,
                              void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % BK || N <= 0 || k <= 0 || stride <= 0 ||
      pad < 0 || sx_mode < 0 || sx_mode > 1 || act < 0 || act > 3 || out_dtype < 0 ||
      out_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.F = F, a.H = H, a.W = W, a.Cp = Cp, a.N = N, a.k = k, a.stride = stride, a.pad = pad;
  a.Ho = (H + 2 * pad - k) / stride + 1;
  a.Wo = (W + 2 * pad - k) / stride + 1;
  if (a.Ho <= 0 || a.Wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.sx_mode = sx_mode, a.act = act, a.out_dtype = out_dtype;
  const long long M = static_cast<long long>(F) * a.Ho * a.Wo;
  const auto st = static_cast<cudaStream_t>(stream);
  const long long m_tiles = (M + BM - 1) / BM;
  if (N <= 64) {
    const long long blocks = m_tiles * ((N + 63) / 64);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    int8_conv_mma<64><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  } else {
    const long long blocks = m_tiles * ((N + 127) / 128);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    int8_conv_mma<128><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
