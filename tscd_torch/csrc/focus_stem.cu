// Eval Focus stem: space-to-depth + 3x3 conv + folded BN + SiLU, computed
// as ONE 6x6 stride-2 convolution (padding 2) over the raw image.
//
// Replaces tscd_tpu/ops/pallas/focus_stem.py (_focus_stem_impl ->
// _kernel). Two kernels, one per output type:
//   focus_stem_kernel  fp32 frames in, fp32 out, fp32 FMA on the CUDA cores;
//   focus_stem_mma     uint8 (or fp32) frames in, bf16 out, bf16 products
//                      on the tensor cores (mma.sync), fp32 sums.
// Both write out (F, OC, H/2, W/2) NCHW, the layout every conv after the
// stem runs in. H and W even, OC a multiple of 8.
//
// ---- fp32: focus_stem_kernel ---------------------------------------------
// The wrapper folds the BN scale into the weights and rearranges them to
// (ky, kx, c, o) tap order, with ky = 2u + dy and kx = 2v + dx for the s2d
// channel (dx*2 + dy)*C + c of the 3x3 kernel: w (6, 6, 3, OC) fp32,
// shift (OC) fp32, x (F, H, W, 3) fp32.
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
// bytes, 62.5 KB at OC = 64.
//
// ---- bf16: focus_stem_mma ------------------------------------------------
// What the Pallas kernel computes at out_dtype bf16 (focus_stem.py:144-148,
// 161, 195): out = bf16(SiLU(shift + sum of bf16(x) * bf16(w6))), the
// sums in fp32. A uint8 pixel is exact in bf16, an fp32 one is rounded as
// it is staged; the wrapper rounds the folded weights. A product of two
// bf16 values is exact in fp32, so the kernel and its plain version
// differ only in the order of the sums and in SiLU's last bits.
//
// Bound at (32, 576, 576, 3) uint8 -> 64 channels: 31.85 MB read and
// 339.7 MB written, 0.111 ms at 3.35 TB/s; its 36.7 GFLOP take 0.037 ms at
// the bf16 tensor-core rate (989 TFLOP/s, wgmma). So bytes bound it, and
// the kernel's job is to keep the write stream going: the products, the
// staging of the input and SiLU have to hide behind it.
//
// Design: an implicit GEMM, D (channels x pixels) = W (channels x K) .
// X (K x pixels), on mma.sync.m16n8k16 (bf16 in, fp32 sums). mma.sync and
// not wgmma: at a fraction of the wgmma rate the products still take under
// the bytes bound, and its register operands let each lane build its own
// columns of X straight from the staged halo (wgmma would read X from
// shared memory in its canonical layout, an im2col copy).
// - K is the 108 taps in (ky, kx, c) order, then 108..110 where X is 1
//   and W holds the shift as three bf16 parts (their fp32 sum is the
//   shift exactly), and 111, zero: 7 k-steps of 16, and the sums start at
//   zero. In NHWC the 18 taps (kx, c) of one ky for output pixel j are the
//   18 contiguous elements of the zero-padded input row 2i+ky-2 from
//   element 6j. 18 is even, so each register of an X fragment (taps k,
//   k+1, k even) lies inside one ky run, at an even element: one aligned
//   32-bit shared load, no im2col copy. ldmatrix does not fit (pixel rows
//   start 12 bytes apart).
// - Channels are the M side: the weights are A fragments, 32 channels
//   (two m16 tiles) x 112 a warp, 56 registers held for the whole
//   persistent loop (loaded once; the wrapper lays them out by lane).
// - Pixels are the N side, 32 consecutive output pixels of one row an
//   item, as 4 n8 tiles. Column n of n8 tile q is pixel
//   8 (n / 2) + 2q + n % 2, so that lane (gid, tid) ends up holding
//   pixels 8 tid .. 8 tid + 7 of channels gid and gid + 8 of each m16
//   tile: one 16-byte NCHW store per channel, 4 lanes writing 64
//   contiguous bytes, with no transpose through shared memory.
// - An item is 32 channels x 32 pixels: 56 mma.sync, 56 shared loads (each
//   X register serves both m16 tiles), 32 SiLUs a lane. A halo row is
//   6 * 32 * groups + 18 bf16 (1746 at W = 576), which is 18 mod 64, so
//   the rows' 32-bit words step 9 banks and an X load is conflict-free
//   except where its 4 lanes straddle two ky rows (4 of 14 loads, 2-way).
// - A tile is TR = 4 output rows x up to 288 pixels (9 groups; one tile
//   spans a 576-wide frame): 72 items at OC = 64 for 8 warps, 9 each.
//   Persistent blocks (2 per SM) walk the tiles with a stride of the grid.
// - Staging, one barrier a tile: the halo is double buffered. Each warp
//   owns halo rows warp and warp + 8: at the start of tile t it copies
//   their uint8 bytes for tile t+1 by 16-byte cp.async into its own raw
//   rows, and after its second item converts them, each pixel once and
//   exactly (a byte permute and one add), into the other halo buffer,
//   zeros outside the frame (rows and columns -2, -1, H, H+1): a copy
//   never reads a neighbouring frame. So the conversion runs between
//   other warps' products, and the barrier at the end of the tile is the
//   only one. Where the rows are not 16-byte aligned (3W % 16 != 0), the
//   frame is wider than one tile, or the frames are fp32, the conversion
//   reads global memory directly.
// - Epilogue: SiLU in fp32 as y / (1 + exp(-y)), ex2 and rcp (two
//   special-function operations an output); packed to bf16 pairs, 16-byte
//   stores where W/2 % 8 == 0, masked scalar stores elsewhere.
// Registers are capped at 128 a thread by __launch_bounds__(256, 2);
// shared memory per block is 2 x 12 x 2 (6 * 32 * groups + 18) bytes of
// halo plus 12 x 3W bytes of raw rows, 104.5 KB at W = 576.
// `-Xptxas -v` output (registers, spills) is in build/kernels/build.log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int CIN = 3;
constexpr int KS = 6;
constexpr int TAPS = KS * KS * CIN;       // 108
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The kernel's shared-memory limit, raised to the card's opt-in maximum
// once a device and kept; `Tag` keeps one record a kernel.
template <typename Tag, typename Kernel>
cudaError_t configure(Kernel kernel, int dev) {
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev, kernel] {
    int optin = 0;
    status[dev] = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (status[dev] == cudaSuccess)
      status[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         optin);
  });
  return status[dev];
}

// The grid of a persistent kernel: as many blocks as fit on the card at
// once (`per_sm` a SM), at most `n`.
template <typename Tag, typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int n, int* grid, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = configure<Tag>(kernel, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem)) !=
          cudaSuccess)
    return err;
  *grid = n < *per_sm * sms ? n : *per_sm * sms;
  return cudaSuccess;
}

// ---- fp32 ------------------------------------------------------------------

constexpr int PX = 4;                     // output columns per thread
constexpr int TW = 32;                    // output columns per tile
constexpr int WARP_ROWS = 4;              // output rows per warp item
constexpr int HALO_W = 2 * TW + KS - 2;   // 68 input columns
constexpr int LINE = HALO_W / 2 + 2;      // 36 floats per (c, row, parity)

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

struct Tiles {
  int H, W, H2, W2, O, TH, HR, tiles_x, per_frame, n;
};

// Starts the copy of `tile`'s halo into `dst`: element (c, r, k) of the
// window at input rows iy0.., columns ix0.. lands at
// ((c * HR + r) * 2 + k % 2) * LINE + k / 2. Thread m < 204 copies
// element m = 3k + c of every row, so a warp reads consecutive elements.
__device__ __forceinline__ void load_halo(float* dst, const float* x,
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
    cp_async4(d, in ? x + src : x, in ? 4 : 0);
  }
}

template <int CB>
__global__ void __launch_bounds__(THREADS, 2)
focus_stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift, float* __restrict__ out,
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
  if (tile < g.n) load_halo(s_x, x, tile, g);
  cp_async_commit();
  for (int it = 0; tile < g.n; ++it, tile += gridDim.x) {
    const float* cur = s_x + (it & 1) * buf;
    const int next = tile + gridDim.x;
    if (next < g.n) load_halo(s_x + ((it + 1) & 1) * buf, x, next, g);
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
          float* dst = out + ((static_cast<size_t>(f) * g.O + cb * CB + o) * g.H2 + oy)
                                 * g.W2 + ox;
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
    __syncthreads();                         // before this buffer is refilled
  }
  cp_async_wait<0>();
}

template <int CB>
int launch(const float* x, const float* w, const float* shift, float* out,
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
  int grid = 0, per_sm = 0;
  const cudaError_t err =
      persistent_grid<std::integral_constant<int, CB>>(focus_stem_kernel<CB>, smem, g.n, &grid,
                                                       &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  focus_stem_kernel<CB><<<grid, THREADS, smem, stream>>>(x, w, shift, out, g, rg);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 ------------------------------------------------------------------

constexpr int TR = 4;                     // output rows a tile
constexpr int HR = 2 * TR + KS - 2;       // 12 halo rows
constexpr int GROUP = 32;                 // output pixels an item
constexpr int MAX_GROUPS = 9;             // pixels a tile: up to 288
constexpr int CHUNK = 32;                 // channels an item: two m16 tiles
constexpr int KSTEPS = 7;                 // 108 taps padded to 112
constexpr int ROW_TAPS = KS * CIN;        // 18 taps of one kernel row

struct MmaTiles {
  int H, W, H2, W2;
  int O, chunks;          // channels written; channel chunks of 32 (padded)
  int groups, cw;         // 32-pixel groups a tile; cw = 32 * groups pixels
  int tiles_x, per_frame, n;
  int rs;                 // bf16 elements a halo row: 6 cw + 18
  int raw_row;            // bytes a staged uint8 row (0: no cp.async staging)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

// D += A . B on the tensor cores: A 16 x 16 bf16 (row), B 16 x 8 bf16
// (col), D 16 x 8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// SiLU in fp32: y / (1 + exp(-y)) as 2^(-y log2 e) and a reciprocal, two
// special-function operations (what __expf and __fdividef compute, without
// their range branches: exp(-y) = inf or d > 2^126 gives 0 here as there).
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Bytes k and k + 1 of v (uint8 pixels) as a bf16 pair, exactly: each byte
// under the exponent of 2^23 is 2^23 + byte as fp32, less 2^23 the byte.
__device__ __forceinline__ unsigned u8_pair_bf16(unsigned v, int k) {
  const float lo = __uint_as_float(__byte_perm(v, 0x4b000000u, 0x7440 + k)) - 8388608.f;
  const float hi = __uint_as_float(__byte_perm(v, 0x4b000000u, 0x7441 + k)) - 8388608.f;
  return pack_bf16(lo, hi);
}

template <typename TIn>
__global__ void __launch_bounds__(THREADS, 2)
focus_stem_mma(const TIn* __restrict__ x, const uint4* __restrict__ wfrag,
               __nv_bfloat16* __restrict__ out, MmaTiles g) {
  // (an extern __shared__ array's name has one type in a translation unit)
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  unsigned* halo = reinterpret_cast<unsigned*>(smem_bytes);  // 2 x HR rows of rs / 2 bf16 pairs
  unsigned char* raw = smem_bytes + 2 * HR * g.rs * 2;       // HR rows of raw_row bytes
  const int half_rs = g.rs / 2;
  const int row_elems = 3 * g.W;            // elements (bytes, if uint8) an input row
  const bool staged = g.raw_row > 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid = lane & 3;

  // byte offsets of this lane's X registers from its pixel's element 0,
  // 2 (ky * rs + t) for tap k = 18 ky + t = 16 s + 8 h + 2 tid, h = 0 in
  // the low and h = 1 in the high 16 bits of offs[s]
  unsigned offs[KSTEPS];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    offs[s] = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * s + 8 * h + 2 * tid;
      const int ky = k / ROW_TAPS;           // taps 108..111 (the shift's): not loaded
      const int off = k < TAPS ? 2 * (ky * g.rs + k - ky * ROW_TAPS) : 0;
      offs[s] |= static_cast<unsigned>(off) << (16 * h);
    }
  }
  // this lane's pixel of column gid in n8 tile 0: 8 (gid / 2) + gid % 2
  const int lane_px = 8 * (gid >> 1) + (gid & 1);
  // X at taps 108..111 (k-step 6, high register, tid 2 and 3): 1, 1, 1, 0,
  // against the weights' three bf16 parts of the shift and a zero
  const unsigned shift_x = tid == 2 ? 0x3f803f80u : 0x00003f80u;

  // Each warp stages its own halo rows, r = warp and warp + 8: the uint8
  // row by 16-byte cp.async into its raw row (the staged case: one tile
  // spans the frame's width, rows 16-byte aligned), later converted into
  // the other halo buffer. No other warp touches a raw row, so a warp's
  // wait and __syncwarp make it visible; the one barrier a tile orders
  // the halo buffers.
  auto tile_origin = [&](int t, int& f, int& i0, int& j0) {
    f = t / g.per_frame;
    const int rem = t - f * g.per_frame;
    const int ty = rem / g.tiles_x;
    i0 = ty * TR;
    j0 = (rem - ty * g.tiles_x) * g.cw;
  };
  auto stage_rows = [&](int t) {
    int f, i0, j0;
    tile_origin(t, f, i0, j0);
    for (int r = warp; r < HR; r += WARPS) {
      const int iy = 2 * i0 - 2 + r;
      if (iy < 0 || iy >= g.H) continue;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x) +
                                 (static_cast<size_t>(f) * g.H + iy) * row_elems;
      for (int c = lane; 16 * c < row_elems; c += 32)
        cp_async16(raw + r * g.raw_row + 16 * c, src + 16 * c);
    }
    cp_async_commit();
  };
  // the halo rows of this warp for tile t, as bf16 pairs: element e of row
  // r is input row 2 i0 - 2 + r, element 6 j0 - 6 + e of its 3W, zero
  // outside the frame
  auto convert_rows = [&](int t, unsigned* dst) {
    int f, i0, j0;
    tile_origin(t, f, i0, j0);
    if (staged) {
      cp_async_wait<0>();
      __syncwarp();
    }
    for (int r = warp; r < HR; r += WARPS) {
      const int iy = 2 * i0 - 2 + r;
      const bool row_in = iy >= 0 && iy < g.H;
      unsigned* hrow = dst + r * half_rs;
      if (staged && row_in) {                // j0 = 0: word 3 + w is raw bytes 2w, 2w + 1
        const unsigned* src = reinterpret_cast<const unsigned*>(raw + r * g.raw_row);
        const int units = row_elems / 4;     // 4 bytes -> 2 words
        for (int c = lane; c < units; c += 32) {
          const unsigned v = src[c];
          hrow[3 + 2 * c] = u8_pair_bf16(v, 0);
          hrow[4 + 2 * c] = u8_pair_bf16(v, 2);
        }
        const int tail = 3 + 2 * units;      // words 0..2 and tail.. are the padding
        for (int w = lane; w < 3 + half_rs - tail; w += 32) hrow[w < 3 ? w : tail + w - 3] = 0u;
        continue;
      }
      const TIn* src = row_in ? x + (static_cast<size_t>(f) * g.H + iy) * row_elems : x;
#pragma unroll 4
      for (int w = lane; w < half_rs; w += 32) {
        const int e = 6 * j0 - 6 + 2 * w;    // even, as 3W is: both in or both out
        float v0 = 0.f, v1 = 0.f;
        if (row_in && e >= 0 && e < row_elems) {
          v0 = static_cast<float>(src[e]);
          v1 = static_cast<float>(src[e + 1]);
        }
        hrow[w] = pack_bf16(v0, v1);
      }
    }
  };

  uint4 wf[KSTEPS][2];                       // this warp's chunk of weights
  int wchunk = -1;

  int tile = blockIdx.x;
  if (tile < g.n) {
    if (staged) stage_rows(tile);
    convert_rows(tile, halo);
  }
  __syncthreads();
  for (int it = 0; tile < g.n; ++it, tile += gridDim.x) {
    // this tile's halo, and the buffer the next tile's rows go to
    const unsigned* cur = halo + (it & 1) * HR * half_rs;
    unsigned* nxt = halo + ((it + 1) & 1) * HR * half_rs;
    const int next = tile + gridDim.x;
    if (staged && next < g.n) stage_rows(next);
    bool converted = next >= g.n;            // the next tile's rows: after 2 items
    int done = 0;
    int f, i0, j0;
    tile_origin(tile, f, i0, j0);

    // this warp's items: item = warp + 8 n is (channel chunk, group, row)
    // = (item % chunks, item / chunks % groups, item / chunks / groups),
    // stepped without divisions
    const int dc = WARPS % g.chunks, dr = WARPS / g.chunks;
    int chunk = warp % g.chunks, grp = warp / g.chunks, lr = 0;
    while (grp >= g.groups) grp -= g.groups, ++lr;
    for (; lr < TR; chunk += dc) {
      const int i = i0 + lr, jg = j0 + GROUP * grp;
      const int item_chunk = chunk, item_grp = grp, item_lr = lr;
      // the next item's
      int step = dr;
      if (chunk + dc >= g.chunks) chunk -= g.chunks, ++step;
      for (grp += step; grp >= g.groups;) grp -= g.groups, ++lr;
      if (i >= g.H2 || jg >= g.W2) continue;
      if (item_chunk != wchunk) {            // once a warp at OC = 64
#pragma unroll
        for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wf[s][mt] = __ldg(wfrag + ((item_chunk * KSTEPS + s) * 2 + mt) * 32 + lane);
        wchunk = item_chunk;
      }

      float acc[2][4][4] = {};               // [m16 tile][n8 tile]; the shift is in K

      // element 0 of this lane's pixel in n8 tile 0; tile q is 2q pixels on
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(cur) +
                                2 * (2 * item_lr * g.rs + 6 * (GROUP * item_grp + lane_px));
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        unsigned b[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned off = (offs[s] >> (16 * h)) & 0xffffu;
            const bool shift_taps = s == KSTEPS - 1 && h == 1 && tid >= 2;
            b[q][h] = shift_taps ? shift_x : *reinterpret_cast<const unsigned*>(xb + 24 * q + off);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_bf16(acc[mt][q], wf[s][mt], b[q][0], b[q][1]);
      }

      // lane holds pixels 8 tid .. 8 tid + 7 of channels gid (+ 8) of each m16 tile
      const int j = jg + 8 * tid;
      const bool vec = (g.W2 & 7) == 0;      // then j + 8 <= W2 wherever j < W2
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = item_chunk * CHUNK + 16 * mt + gid + 8 * hh;
          unsigned v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = pack_bf16(silu(acc[mt][q][2 * hh]), silu(acc[mt][q][2 * hh + 1]));
          if (o >= g.O || j >= g.W2) continue;
          __nv_bfloat16* dst = out + ((static_cast<size_t>(f) * g.O + o) * g.H2 + i) * g.W2 + j;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
          } else {
            const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(v);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (j + e < g.W2) dst[e] = vb[e];
          }
        }
      }
      if (++done == 2 && !converted) {       // the next tile's rows, between items
        convert_rows(next, nxt);
        converted = true;
      }
    }
    if (!converted) convert_rows(next, nxt);
    __syncthreads();                         // next's halo is whole; cur is free
  }
}

template <typename TIn>
struct MmaTag {};

MmaTiles mma_tiles(int F, int H, int W, int OC) {
  MmaTiles g;
  g.H = H; g.W = W; g.H2 = H / 2; g.W2 = W / 2;
  g.O = OC; g.chunks = (OC + CHUNK - 1) / CHUNK;
  const int groups = (g.W2 + GROUP - 1) / GROUP;
  g.groups = groups < MAX_GROUPS ? groups : MAX_GROUPS;
  g.cw = GROUP * g.groups;
  g.tiles_x = (g.W2 + g.cw - 1) / g.cw;
  g.per_frame = ((g.H2 + TR - 1) / TR) * g.tiles_x;
  g.n = F * g.per_frame;
  g.rs = 6 * g.cw + 18;                     // 6 cw = 0 mod 64: rs = 18 mod 64
  g.raw_row = 0;
  return g;
}

size_t mma_smem(const MmaTiles& g) {
  return static_cast<size_t>(HR) * (4 * g.rs + g.raw_row);
}

template <typename TIn>
int launch_mma(const TIn* x, const void* wfrag, void* out, int F, int H, int W, int OC,
               cudaStream_t stream) {
  MmaTiles g = mma_tiles(F, H, W, OC);
  if (std::is_same<TIn, unsigned char>::value && g.tiles_x == 1 && (3 * W) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    g.raw_row = 3 * W;
  int grid = 0, per_sm = 0;
  const size_t smem = mma_smem(g);
  const cudaError_t err =
      persistent_grid<MmaTag<TIn>>(focus_stem_mma<TIn>, smem, g.n, &grid, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  focus_stem_mma<TIn><<<grid, THREADS, smem, stream>>>(
      x, static_cast<const uint4*>(wfrag), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int F, int H, int W, int C, int OC) {
  return C != CIN || OC < 8 || OC % 8 != 0 || H < 2 || W < 2 || H % 2 || W % 2 || F < 1;
}

}  // namespace

// fp32 frames, fp32 out: x (F, H, W, 3), w (6, 6, 3, OC) folded weights,
// shift (OC), out (F, OC, H/2, W/2).
extern "C" int tscd_focus_stem(const void* x, const void* w, const void* shift,
                               void* out, int F, int H, int W, int C, int OC,
                               void* stream) {
  if (bad_shape(F, H, W, C, OC)) return static_cast<int>(cudaErrorInvalidValue);
  const auto xs = static_cast<const float*>(x);
  const auto ws = static_cast<const float*>(w);
  const auto ss = static_cast<const float*>(shift);
  const auto os = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return OC % 16 == 0 ? launch<16>(xs, ws, ss, os, F, H, W, OC, st)
                      : launch<8>(xs, ws, ss, os, F, H, W, OC, st);
}

// bf16 out: x (F, H, W, 3) uint8 (x_u8) or fp32; wfrag the weights and
// shift as ops/kernels/focus_stem.py:weight_fragments lays them out; out
// (F, OC, H/2, W/2) bf16.
extern "C" int tscd_focus_stem_bf16(const void* x, const void* wfrag, void* out, int F, int H,
                                    int W, int C, int OC, int x_u8, void* stream) {
  if (bad_shape(F, H, W, C, OC)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return x_u8 ? launch_mma(static_cast<const unsigned char*>(x), wfrag, out, F, H, W, OC, st)
              : launch_mma(static_cast<const float*>(x), wfrag, out, F, H, W, OC, st);
}

// The bf16 kernel's launch at a shape, for the record: out[0] the dynamic
// shared memory a block (bytes), out[1] its blocks per SM, out[2] its
// registers a thread, out[3] its local memory a thread (bytes, spills).
extern "C" int tscd_focus_stem_bf16_config(int H, int W, int OC, int x_u8, int* out) {
  MmaTiles g = mma_tiles(1, H, W, OC);
  if (x_u8 && g.tiles_x == 1 && (3 * W) % 16 == 0) g.raw_row = 3 * W;
  const size_t smem = mma_smem(g);
  int grid = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err =
      x_u8 ? persistent_grid<MmaTag<unsigned char>>(focus_stem_mma<unsigned char>, smem, 1,
                                                    &grid, &per_sm)
           : persistent_grid<MmaTag<float>>(focus_stem_mma<float>, smem, 1, &grid, &per_sm);
  if (err == cudaSuccess)
    err = x_u8 ? cudaFuncGetAttributes(&attr, focus_stem_mma<unsigned char>)
               : cudaFuncGetAttributes(&attr, focus_stem_mma<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
