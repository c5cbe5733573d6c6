// Linear sum assignment: Jonker-Volgenant shortest augmenting path, one
// warp a matrix.
//
// Replaces tscd_tpu/ops/pallas/hungarian.py (linear_sum_assignment_pallas
// -> _kernel) and follows the same algorithm step for step as the XLA
// lowering in tscd_tpu/ops/hungarian.py, with the same fp32 operations in
// the same order, r = ((mv + c[i,j]) - u[i]) - v[j], and the same tie rule
// (the argmin takes the FIRST minimal column), so col4row is equal element
// for element.
//
// Layout: cost (B, n, n) fp32 of B independent square matrices, n <= 128;
// col4row (B, n) int32. On the main path the matcher launches it once per
// local frame with B = 1: frame i's cost reads the bank that frame i-1's
// assignment wrote, so frames cannot be batched.
//
// Bound: latency. A matrix takes n row insertions, each a chain of
// dependent Dijkstra steps (n(n+1)/2 of them on the sequence start's
// constant cost, about 260 on a random 50 x 50 one). Bytes and FLOPs are
// negligible; the cycles of one step's dependent chain times the number
// of steps set the time.
//
// Design: one warp a matrix and no block barrier anywhere; the warps of a
// block take consecutive matrices of the batch. Lane l owns columns l,
// l+32, l+64, l+96 (those below n), slot s holding column l + 32 s: its
// shortest-path cost spc, predecessor path, key, dual v, row4col and
// ubc (below) in registers, and col4row of the row of the same index.
// Slots are indexed only by compile-time indices (a template on
// S = ceil(n / 32)), so nothing lives in local memory. Shared memory
// holds, per warp: the cost matrix (copied in once, 16-byte cp.async
// where aligned); cbc, for each assigned column, a copy of its row's
// cost row, in rows of 32 S words so a lane's slots sit at fixed offsets;
// and the copies other lanes read: ubc, row4col, col4row, and path
// (written once per row insertion for the augmenting walk).
// The row duals live with their columns (ubc): a visited row other than
// cur is the row of a column the search took, so the lowering's
// u[r] + (mv - spc[col4row[r]]) is ubc[j] + (mv - spc[j]) in column j's
// lane, and a row that moves along the augmenting path carries its u to
// its new column. A row not yet inserted has u = 0. Every lane walks the
// augmenting path on the shared copies, which change only after the
// walk, so the walk needs no barrier per link.
//
// One Dijkstra step and the chain it waits on: the shared load of the
// step's cost row (cbc[jmin]: the next row needs no lookup of row4col,
// and the loads issue before the step's end is tested); three fp32 adds;
// the order-preserving uint32 key of r (-0.0 canonicalised to +0.0
// first, as the JAX argmin treats the two as equal), selected into the
// slot where r < lim (lim is spc while the column remains and -inf once
// taken, so one compare is the lowering's (r < spc) & remaining); the
// key packed with its column as (key >> 7, column) and the lane's
// minimum; one redux.sync of the packed keys, whose minimum's column is
// the first minimal column unless a larger key of the minimum's class of
// 128 sits there. A second redux.sync of the full keys, beside the first,
// gives the minimum itself (decoded, the step's min value) and tells that
// case apart (a vote), which a third redux.sync of the columns holding
// the minimum then settles. Every lane holds the step's min value, column
// and next row, so control flow is warp-uniform around every *_sync.
//
// Resources (nvcc -Xptxas -v, build/kernels/build.log): 32, 40, 54 and 62
// registers for S = 1..4, no spills, no stack frame; shared memory
// warp_words(n) words a warp (23.1 KB at n = 50, 130 KB at n = 128).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int NMAX = 128;
constexpr int MAX_WARPS = 4;            // matrices a block, at most
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned KEY_PAST_N = 0xffffffffu;   // a column >= n: never the min
constexpr unsigned KEY_INF = 0xff800000u;      // order_key(+inf)
constexpr unsigned COL_MASK = NMAX - 1;        // a column index: 7 bits

// Order-preserving map of a float to uint32: a < b (as floats, -0.0 ==
// +0.0) iff key(a) < key(b).
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x + 0.0f);    // -0.0 -> +0.0
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// Minimum over the whole warp (redux.sync): every call site is reached by
// all 32 lanes.
__device__ __forceinline__ unsigned warp_min(unsigned x) {
  unsigned m;
  asm volatile("redux.sync.min.u32 %0, %1, 0xffffffff;" : "=r"(m) : "r"(x));
  return m;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Words of shared memory a warp uses: the cost matrix (n x n, rounded to
// 16 bytes); cbc (n rows of 32 S words, so a lane's slots sit at fixed
// offsets from the row); ubc, path, row4col, col4row.
__host__ __device__ constexpr int warp_words(int n) {
  return round4(n * n) + n * 32 * ((n + 31) / 32) + 4 * round4(n);
}

__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

// Shared-memory loads at a 32-bit shared address: the step's addresses
// are one multiply-add from the winning column, with no generic-to-shared
// conversion on the chain.
__device__ __forceinline__ float lds_f32(unsigned a) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
  return x;
}

__device__ __forceinline__ int lds_s32(unsigned a) {
  int x;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(x) : "r"(a));
  return x;
}

template <int S>
__global__ void __launch_bounds__(32 * MAX_WARPS)
linear_sum_assignment_warp(const float* __restrict__ cost,
                           int* __restrict__ col4row_out, int B, int n) {
  constexpr int RS = 32 * S;            // row stride of cbc
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int nn = n * n, n4 = round4(n);
  float* s_cost = smem + warp * warp_words(n);
  float* s_cbc = s_cost + round4(nn);
  float* s_ubc = s_cbc + n * RS;
  int* s_path = reinterpret_cast<int*>(s_ubc + n4);
  int* s_r4c = s_path + n4;
  int* s_c4r = s_r4c + n4;

  // the cost matrix, every copy in flight at once
  const float* c = cost + static_cast<size_t>(b) * nn;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(c) & 15) == 0) {
    for (int k = 4 * lane; k + 4 <= nn; k += 128) copy_async(s_cost + k, c + k, 16);
    k0 = nn & ~3;
  }
  for (int k = k0 + lane; k < nn; k += 32) copy_async(s_cost + k, c + k, 4);
  asm volatile("cp.async.wait_all;" ::: "memory");
  for (int k = lane; k < n; k += 32) {
    s_ubc[k] = 0.f;
    s_r4c[k] = -1;
    s_c4r[k] = -1;
  }

  // slot s: column (and row) lane + 32 s; jc clamps it into a cost row.
  // The lane keeps its columns' row4col and ubc, and its rows' col4row,
  // in registers too; shared memory holds the copies other lanes read.
  int col[S], jc[S], r4c[S], c4r[S];
  bool live[S];
  float v[S], ubc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    col[s] = lane + 32 * s;
    live[s] = lane + 32 * s < n;
    jc[s] = live[s] ? lane + 32 * s : n - 1;
    v[s] = 0.f;
    ubc[s] = 0.f;
    r4c[s] = -1;
    c4r[s] = -1;
  }
  const unsigned a_cbc = static_cast<unsigned>(__cvta_generic_to_shared(s_cbc + lane));
  const unsigned a_ubc = static_cast<unsigned>(__cvta_generic_to_shared(s_ubc));
  const unsigned a_r4c = static_cast<unsigned>(__cvta_generic_to_shared(s_r4c));
  __syncwarp();

  for (int cur = 0; cur < n; ++cur) {
    // --- Dijkstra to the nearest unassigned column ----------------------
    // lim: spc while the column remains, -inf once it is taken (and for
    // a slot past n), so that `r < lim` is the lowering's
    // `(r < spc) & remaining` in one compare; key: order_key of spc while
    // the column remains, KEY_INF once taken, KEY_PAST_N past n
    float spc[S], lim[S], cr[S];
    int path[S];
    unsigned key[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      spc[s] = INFINITY;
      lim[s] = live[s] ? INFINITY : -INFINITY;
      key[s] = live[s] ? KEY_INF : KEY_PAST_N;
      path[s] = -1;
      cr[s] = s_cost[cur * n + jc[s]];
    }
    // u[cur] is still 0: only rows assigned before, and cur, ever change
    int i = cur, sink = -1;
    float ui = 0.f, mv = 0.f;
    // each step's cost row (cbc[jmin]: the row assigned to column jmin)
    // and u are loaded before the step's end is tested
    while (true) {
      unsigned low = KEY_PAST_N, packed = KEY_PAST_N;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float r = ((mv + cr[s]) - ui) - v[s];
        const bool better = r < lim[s];
        const unsigned kr = order_key(r);
        spc[s] = better ? r : spc[s];
        lim[s] = better ? r : lim[s];
        path[s] = better ? i : path[s];
        key[s] = better ? kr : key[s];
        low = min(low, key[s]);
        packed = min(packed, (key[s] & ~COL_MASK) | static_cast<unsigned>(col[s]));
      }
      const unsigned kmin = warp_min(low);
      // (key >> 7, column) packed in 32 bits: its warp minimum is the first
      // column of kmin's class of 128 keys, which is the first minimal
      // column unless that column holds a larger key of the class
      int jmin = static_cast<int>(warp_min(packed) & COL_MASK);
      unsigned a_row = a_cbc + jmin * (4 * RS);
#pragma unroll
      for (int s = 0; s < S; ++s) cr[s] = lds_f32(a_row + 128 * s);
      float u_next = lds_f32(a_ubc + 4 * jmin);
      int nxt = lds_s32(a_r4c + 4 * jmin);
      bool off = false;
#pragma unroll
      for (int s = 0; s < S; ++s) off = off || (col[s] == jmin && key[s] != kmin);
      if (__any_sync(FULL, off)) {      // keys within 128 ulps of the min
        unsigned cand = KEY_PAST_N;
#pragma unroll
        for (int s = S - 1; s >= 0; --s)
          if (key[s] == kmin) cand = static_cast<unsigned>(col[s]);
        jmin = static_cast<int>(warp_min(cand));
        a_row = a_cbc + jmin * (4 * RS);
#pragma unroll
        for (int s = 0; s < S; ++s) cr[s] = lds_f32(a_row + 128 * s);
        u_next = lds_f32(a_ubc + 4 * jmin);
        nxt = lds_s32(a_r4c + 4 * jmin);
      }
      mv = key_value(kmin);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (col[s] == jmin) {
          lim[s] = -INFINITY;
          key[s] = KEY_INF;
        }
      }
      if (nxt < 0) {
        sink = jmin;
        break;
      }
      i = nxt;
      ui = u_next;
    }

    // --- dual updates, as the XLA lowering orders them -------------------
    // v of every taken column; u of every visited row but cur, that is of
    // the row assigned to each taken column but the sink, which its column
    // holds as ubc: ubc + (mv - spc) is the lowering's u + (mv - spc[c4r]).
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool done = live[s] && lim[s] == -INFINITY;
      v[s] = v[s] - (done ? mv - spc[s] : 0.f);
      if (done && r4c[s] >= 0) ubc[s] = ubc[s] + (mv - spc[s]);
      if (live[s]) {
        s_path[col[s]] = path[s];
        s_ubc[col[s]] = ubc[s];
      }
    }
    __syncwarp();

    // --- augment along the predecessor path ------------------------------
    // Every lane walks it on the shared copies, which stay as they are
    // until it ends; the owners take the new links into their registers.
    // The row a column takes brings its u (cur's: 0 + mv; any other's from
    // the column it leaves) and its cost row.
    int j = sink;
    while (true) {
      const int ii = s_path[j];
      const int next_j = s_c4r[ii];
      const float uu = ii == cur ? 0.f + mv : s_ubc[next_j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (col[s] == j) {
          r4c[s] = ii;
          ubc[s] = uu;
        }
        if (col[s] == ii) c4r[s] = j;
        if (live[s]) s_cbc[j * RS + col[s]] = s_cost[ii * n + col[s]];
      }
      if (ii == cur) break;
      j = next_j;
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (live[s]) {
        s_r4c[col[s]] = r4c[s];
        s_c4r[col[s]] = c4r[s];
        s_ubc[col[s]] = ubc[s];
      }
    }
    __syncwarp();    // ubc, row4col, col4row, cbc written before the next insertion
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (live[s])
      col4row_out[static_cast<size_t>(b) * n + col[s]] = c4r[s];
}

// The kernels' dynamic shared-memory limit, raised once a device to what
// the device allows a block; returns that limit in bytes.
cudaError_t configure(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  static int optin[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    cudaError_t e = cudaDeviceGetAttribute(
        &optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const void* fns[] = {
        reinterpret_cast<const void*>(linear_sum_assignment_warp<1>),
        reinterpret_cast<const void*>(linear_sum_assignment_warp<2>),
        reinterpret_cast<const void*>(linear_sum_assignment_warp<3>),
        reinterpret_cast<const void*>(linear_sum_assignment_warp<4>)};
    for (const void* fn : fns) {
      if (e != cudaSuccess) break;
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin[dev]);
    }
    status[dev] = e;
  });
  *limit = optin[dev];
  return status[dev];
}

// ---------------------------------------------------------------------------
// n > 128: one block a matrix (the counterpart of the XLA lowering that the
// JAX package takes for n > 128, tscd_tpu/ops/hungarian.py:69-128).
//
// Thread t owns columns t, t + T, t + 2T, ... (T = blockDim.x, at most 1024
// threads, so a thread owns ceil(n / 1024) columns past n = 1024). Each
// column's spc, path, remaining flag and dual v, and each row's dual u,
// col4row and visited flag, live in shared memory (n = 500: 14 KB); the
// cost rows are read from global memory (n = 500: 1 MB, in L2), one
// coalesced row a Dijkstra step. The step's argmin is a warp shuffle
// reduction of (value, column) pairs with ties to the lower column, then
// one across the warps in warp 0, between two block barriers. The dual
// updates and the augmenting walk follow the lowering in order; the walk
// is serial, on thread 0. Same fp32 operations in the same order as the
// lowering, r = ((mv + c[i,j]) - u[i]) - v[j], so col4row is equal
// element for element.
//
// Bound: latency, like the warp kernel, with a longer step: a cost load
// from L1/L2, three adds, two shuffle reductions and two barriers.

__device__ __forceinline__ void argmin_pair(float& val, int& idx, float ov, int oi) {
  if (ov < val || (ov == val && oi < idx)) {
    val = ov;
    idx = oi;
  }
}

__device__ __forceinline__ void warp_argmin(float& val, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmin_pair(val, idx, __shfl_down_sync(FULL, val, o), __shfl_down_sync(FULL, idx, o));
}

constexpr int BLOCK_THREADS_MAX = 1024;
constexpr int BLOCK_NMAX = 4096;

__host__ __device__ constexpr size_t block_smem_bytes(int n) {
  return static_cast<size_t>(n) * (3 * sizeof(float) + 3 * sizeof(int) + 2);
}

__global__ void __launch_bounds__(BLOCK_THREADS_MAX)
linear_sum_assignment_block(const float* __restrict__ cost,
                            int* __restrict__ col4row_out, int n) {
  extern __shared__ __align__(16) float bsm[];
  __shared__ float s_wval[32];
  __shared__ int s_widx[32];
  __shared__ int s_i, s_sink;
  __shared__ float s_min;
  float* s_v = bsm;
  float* s_spc = s_v + n;
  float* s_u = s_spc + n;
  int* s_path = reinterpret_cast<int*>(s_u + n);
  int* s_r4c = s_path + n;
  int* s_c4r = s_r4c + n;
  unsigned char* s_rem = reinterpret_cast<unsigned char*>(s_c4r + n);
  unsigned char* s_sr = s_rem + n;
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int j = t; j < n; j += T) {
    s_v[j] = 0.f;
    s_u[j] = 0.f;
    s_r4c[j] = -1;
    s_c4r[j] = -1;
  }
  for (int cur = 0; cur < n; ++cur) {
    for (int j = t; j < n; j += T) {
      s_spc[j] = INFINITY;
      s_path[j] = -1;
      s_rem[j] = 1;
      s_sr[j] = 0;
    }
    if (t == 0) {
      s_i = cur;
      s_min = 0.f;
      s_sink = -1;
    }
    __syncthreads();
    // --- Dijkstra to the nearest unassigned column ----------------------
    while (true) {
      const int i = s_i;
      const float mv = s_min;
      const float ui = s_u[i];
      const float* ci = c + static_cast<size_t>(i) * n;
      if (t == 0) s_sr[i] = 1;
      // masked = where(remaining, spc, inf); argmin takes the first minimum
      float val = INFINITY;
      int idx = 0x7fffffff;
      for (int j = t; j < n; j += T) {
        float spc = s_spc[j];
        const bool rem = s_rem[j] != 0;
        if (rem) {
          const float r = ((mv + __ldg(ci + j)) - ui) - s_v[j];
          if (r < spc) {
            spc = r;
            s_spc[j] = r;
            s_path[j] = i;
          }
        }
        argmin_pair(val, idx, rem ? spc : INFINITY, j);
      }
      warp_argmin(val, idx);
      if (lane == 0) {
        s_wval[warp] = val;
        s_widx[warp] = idx;
      }
      __syncthreads();
      if (warp == 0) {
        val = lane < nwarps ? s_wval[lane] : INFINITY;
        idx = lane < nwarps ? s_widx[lane] : 0x7fffffff;
        warp_argmin(val, idx);
        if (lane == 0) {
          s_min = val;
          s_rem[idx] = 0;
          const int nxt = s_r4c[idx];
          if (nxt < 0)
            s_sink = idx;
          else
            s_i = nxt;
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }
    // --- dual updates, as the XLA lowering orders them -------------------
    const float mv = s_min;
    for (int j = t; j < n; j += T) {
      if (j == cur)
        s_u[j] = s_u[j] + mv;
      else if (s_sr[j])
        s_u[j] = s_u[j] + (mv - s_spc[s_c4r[j]]);
      if (!s_rem[j]) s_v[j] = s_v[j] - (mv - s_spc[j]);
    }
    __syncthreads();
    // --- augment along the predecessor path ------------------------------
    if (t == 0) {
      int j = s_sink;
      while (true) {
        const int i = s_path[j];
        s_r4c[j] = i;
        const int next_j = s_c4r[i];
        s_c4r[i] = j;
        if (i == cur) break;
        j = next_j;
      }
    }
    __syncthreads();
  }
  for (int j = t; j < n; j += T)
    col4row_out[static_cast<size_t>(blockIdx.x) * n + j] = s_c4r[j];
}

cudaError_t configure_block() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    status[dev] = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(linear_sum_assignment_block),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(block_smem_bytes(BLOCK_NMAX)));
  });
  return status[dev];
}

}  // namespace

extern "C" int tscd_linear_sum_assignment(const void* cost, void* col4row,
                                          int B, int n, void* stream) {
  if (n < 1 || n > NMAX || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err = configure(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t per_warp = sizeof(float) * warp_words(n);
  int warps = static_cast<int>(limit / per_warp);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  if (warps > B) warps = B;
  const dim3 grid((B + warps - 1) / warps), block(32 * warps);
  const size_t smem = per_warp * warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cost);
  int* out = static_cast<int*>(col4row);
  switch ((n + 31) / 32) {
    case 1: linear_sum_assignment_warp<1><<<grid, block, smem, st>>>(c, out, B, n); break;
    case 2: linear_sum_assignment_warp<2><<<grid, block, smem, st>>>(c, out, B, n); break;
    case 3: linear_sum_assignment_warp<3><<<grid, block, smem, st>>>(c, out, B, n); break;
    default: linear_sum_assignment_warp<4><<<grid, block, smem, st>>>(c, out, B, n); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tscd_linear_sum_assignment_block(const void* cost, void* col4row,
                                                int B, int n, void* stream) {
  if (n < 1 || n > BLOCK_NMAX || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure_block();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n < BLOCK_THREADS_MAX ? (n + 31) / 32 * 32 : BLOCK_THREADS_MAX;
  linear_sum_assignment_block<<<B, threads, block_smem_bytes(n),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(col4row), n);
  return static_cast<int>(cudaGetLastError());
}
