// Greedy NMS walk: which boxes survive, in score order, given which
// earlier box overlaps which.
//
// Replaces no Pallas kernel. It replaces the XLA `lax.scan` of
// tscd_tpu/ops/nms.py:55 (nms_fixed), the only exact form of greedy NMS
// there that waits on nothing: K dependent steps, each deciding one box.
// PyTorch has no device loop, so the port's plain version iterates a fixed
// point and reads the host to test convergence; this kernel walks the K
// steps on the card, so the postprocess enqueues without waiting.
//
// Inputs (both contiguous, bool as one byte): sup (B, K, K), in score
// order, sup[b, i, j] = box j comes before box i and overlaps it (the
// `overlap & earlier` matrix of ops/nms.py; only j < i is read); valid
// (B, K), in score order. Output keep (B, K) bool, in score order:
//   keep[i] = valid[i] & !any_{j < i} (sup[i, j] & keep[j]).
// Scratch bits (B, K + 1, W) uint32, W = ceil(K / 32) rounded up to a
// multiple of 4 (16-byte rows).
//
// Bound: latency. The K decisions form one dependent chain (each needs
// every earlier one). Bytes: K^2 bools read once, 2.25 MB at the main
// path's K = 1500 (0.7 us at 3.35 TB/s); a step's chain is a word AND,
// one warp vote and a select, about 25 cycles, 19 us at K = 1500.
//
// Design: two launches.
// 1. nms_pack_rows, over the whole card: one warp a row packs the row's
//    bytes j < i into W bit words with __ballot_sync (32 coalesced bytes a
//    load); row K of each frame packs `valid`.
// 2. nms_walk, one block a frame: warp 0 walks the rows in order while
//    the other warps copy the next chunk of CHUNK packed rows into the
//    other half of a double buffer in shared memory (one block barrier a
//    chunk). Lane l holds keep words l + 32 s (s < S) in registers and
//    ANDs them with the same words of row i, read from shared memory one
//    row ahead; __any_sync of the result decides box i, and the lane that
//    owns bit i sets it. So a step is the word AND, the vote and a select,
//    with no shared-memory store or barrier on the chain.
//
// Resources: W <= 32 S words a row, S <= 8, so K <= 8192; shared memory
// (2 CHUNK + 1) W words, 24.8 KB at K = 1500.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_S = 8;
constexpr int KMAX = 32 * 32 * MAX_S;
constexpr int CHUNK = 64;                 // packed rows a buffer
constexpr int WALK_THREADS = 256;
constexpr int PACK_WARPS = 8;
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int row_words(int K) {
  return ((K + 31) / 32 + 3) & ~3;
}

__global__ void __launch_bounds__(32 * PACK_WARPS)
nms_pack_rows(const uint8_t* __restrict__ sup,
              const uint8_t* __restrict__ valid,
              unsigned* __restrict__ bits, int K) {
  const int b = blockIdx.y;
  const int r = blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r > K) return;
  const int W = row_words(K);
  unsigned* out = bits + (static_cast<size_t>(b) * (K + 1) + r) * W;
  // row r < K: its columns j < r; row K: the valid mask
  const uint8_t* src = r < K ? sup + (static_cast<size_t>(b) * K + r) * K
                             : valid + static_cast<size_t>(b) * K;
  const int lim = r < K ? r : K;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const int c = 32 * w + lane;
    const unsigned word = __ballot_sync(FULL, c < lim && src[c] != 0);
    if (lane == (w & 31)) out[w] = word;
  }
}

template <int S>
__global__ void __launch_bounds__(WALK_THREADS)
nms_walk(const unsigned* __restrict__ bits, uint8_t* __restrict__ keep_out,
         int K) {
  extern __shared__ __align__(16) unsigned smem[];
  const int W = row_words(K);
  unsigned* const buf0 = smem;
  unsigned* const buf1 = smem + CHUNK * W;
  unsigned* s_keep = smem + 2 * CHUNK * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned* src = bits + static_cast<size_t>(blockIdx.x) * (K + 1) * W;
  const int nchunks = (K + CHUNK - 1) / CHUNK;

  // rows [c CHUNK, (c + 1) CHUNK) of the frame, 16 bytes a thread
  auto copy_chunk = [&](int c, unsigned* dst, int t0, int nt) {
    const int r0 = c * CHUNK;
    const int rows = min(CHUNK, K - r0);
    const uint4* s = reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0) * W);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int k = t0; k < rows * W / 4; k += nt) d[k] = s[k];
  };

  copy_chunk(0, buf0, tid, WALK_THREADS);
  unsigned keep[S], valid[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int w = lane + 32 * s;
    keep[s] = 0u;
    valid[s] = w < W ? src[static_cast<size_t>(K) * W + w] : 0u;
  }
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    if (warp == 0) {
      const unsigned* rows = (c & 1) ? buf1 : buf0;
      const int r0 = c * CHUNK, n_rows = min(CHUNK, K - r0);
      unsigned next[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        next[s] = lane + 32 * s < W ? rows[lane + 32 * s] : 0u;
      for (int rr = 0; rr < n_rows; ++rr) {
        unsigned row[S];
#pragma unroll
        for (int s = 0; s < S; ++s) row[s] = next[s];
        if (rr + 1 < n_rows) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            next[s] = lane + 32 * s < W ? rows[(rr + 1) * W + lane + 32 * s] : 0u;
        }
        // box i's bit, in the lane and slot that own it (off the chain)
        const int i = r0 + rr;
        unsigned cand[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          cand[s] = lane + 32 * s == (i >> 5) ? valid[s] & (1u << (i & 31)) : 0u;
        unsigned hit = 0u;
#pragma unroll
        for (int s = 0; s < S; ++s) hit |= row[s] & keep[s];
        const bool suppressed = __any_sync(FULL, hit != 0u);
#pragma unroll
        for (int s = 0; s < S; ++s) keep[s] |= suppressed ? 0u : cand[s];
      }
    } else if (c + 1 < nchunks) {
      copy_chunk(c + 1, (c & 1) ? buf0 : buf1, tid - 32, WALK_THREADS - 32);
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (lane + 32 * s < W) s_keep[lane + 32 * s] = keep[s];
  }
  __syncthreads();
  uint8_t* out = keep_out + static_cast<size_t>(blockIdx.x) * K;
  for (int j = tid; j < K; j += WALK_THREADS)
    out[j] = static_cast<uint8_t>((s_keep[j >> 5] >> (j & 31)) & 1u);
}

// Raises the walk kernels' dynamic shared-memory limit once a device.
cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    const int bytes = static_cast<int>(sizeof(unsigned) * (2 * CHUNK + 1) * row_words(KMAX));
    const void* fns[] = {reinterpret_cast<const void*>(nms_walk<1>),
                         reinterpret_cast<const void*>(nms_walk<2>),
                         reinterpret_cast<const void*>(nms_walk<4>),
                         reinterpret_cast<const void*>(nms_walk<8>)};
    cudaError_t e = cudaSuccess;
    for (const void* fn : fns) {
      if (e != cudaSuccess) break;
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    }
    status[dev] = e;
  });
  return status[dev];
}

}  // namespace

extern "C" int tscd_nms_walk(const void* sup, const void* valid, void* bits,
                             void* keep, int B, int K, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > KMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 pack_grid((K + 1 + PACK_WARPS - 1) / PACK_WARPS, B);
  nms_pack_rows<<<pack_grid, 32 * PACK_WARPS, 0, st>>>(
      static_cast<const uint8_t*>(sup), static_cast<const uint8_t*>(valid),
      static_cast<unsigned*>(bits), K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = row_words(K);
  const size_t smem = sizeof(unsigned) * (2 * CHUNK + 1) * W;
  const unsigned* b = static_cast<const unsigned*>(bits);
  uint8_t* out = static_cast<uint8_t*>(keep);
  const int S = (W + 31) / 32;
  if (S <= 1)
    nms_walk<1><<<B, WALK_THREADS, smem, st>>>(b, out, K);
  else if (S <= 2)
    nms_walk<2><<<B, WALK_THREADS, smem, st>>>(b, out, K);
  else if (S <= 4)
    nms_walk<4><<<B, WALK_THREADS, smem, st>>>(b, out, K);
  else
    nms_walk<8><<<B, WALK_THREADS, smem, st>>>(b, out, K);
  return static_cast<int>(cudaGetLastError());
}
