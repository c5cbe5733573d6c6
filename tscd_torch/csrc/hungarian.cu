// Linear sum assignment: Jonker-Volgenant shortest augmenting path.
//
// Replaces tscd_tpu/ops/pallas/hungarian.py (linear_sum_assignment_pallas
// -> _kernel) and follows the same algorithm step for step as the XLA
// lowering in tscd_tpu/ops/hungarian.py, with the same fp32 operations in
// the same order and the same tie rule (the argmin takes the FIRST
// minimal column), so col4row is equal element for element.
//
// Layout: cost (B, n, n) fp32 of B independent square matrices, n <= 128;
// col4row (B, n) int32. One block of 128 threads per matrix: thread j
// owns column j's shortest-path cost, predecessor, `remaining` flag and
// dual v, and row j's dual u. The cost matrix sits in shared memory. The
// argmin of each Dijkstra step is a warp shuffle over (value, index)
// pairs plus one shared-memory step across the 4 warps.
//
// Bound: latency. A matrix takes n row insertions, each a chain of
// dependent Dijkstra steps (each step a block-wide argmin and two
// barriers) plus a serial augmentation. The work is O(n^2) per insertion
// but the dependent-step count, not bytes or FLOPs, sets the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NMAX = 128;
constexpr int WARPS = NMAX / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void argmin_step(float& val, int& idx, float ov,
                                            int oi) {
  if (ov < val || (ov == val && oi < idx)) {
    val = ov;
    idx = oi;
  }
}

__global__ void __launch_bounds__(NMAX)
linear_sum_assignment_kernel(const float* __restrict__ cost,
                             int* __restrict__ col4row_out, int n) {
  extern __shared__ float s_cost[];  // n x n
  __shared__ float s_u[NMAX], s_v[NMAX], s_spc[NMAX];
  __shared__ int s_row4col[NMAX], s_col4row[NMAX], s_path[NMAX];
  __shared__ unsigned char s_sr[NMAX];
  __shared__ float s_wval[WARPS];
  __shared__ int s_widx[WARPS];
  __shared__ int s_i, s_jmin, s_sink;
  __shared__ float s_min;

  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int idx = j; idx < n * n; idx += NMAX) s_cost[idx] = c[idx];
  s_u[j] = 0.f;
  s_v[j] = 0.f;
  s_row4col[j] = -1;
  s_col4row[j] = -1;

  for (int cur = 0; cur < n; ++cur) {
    // --- Dijkstra to the nearest unassigned column ----------------------
    bool rem = j < n;
    float spc = INFINITY;
    int path = -1;
    s_sr[j] = 0;
    if (j == 0) {
      s_i = cur;
      s_min = 0.f;
    }
    __syncthreads();
    while (true) {
      const int i = s_i;
      const float mv = s_min;
      if (j == 0) s_sr[i] = 1;
      if (rem) {
        const float r = mv + s_cost[i * n + j] - s_u[i] - s_v[j];
        if (r < spc) {
          spc = r;
          path = i;
        }
      }
      float val = rem ? spc : INFINITY;
      int idx = j;
      for (int o = 16; o > 0; o >>= 1)
        argmin_step(val, idx, __shfl_down_sync(FULL, val, o),
                    __shfl_down_sync(FULL, idx, o));
      if (lane == 0) {
        s_wval[warp] = val;
        s_widx[warp] = idx;
      }
      __syncthreads();
      if (j == 0) {
        float bv = s_wval[0];
        int bi = s_widx[0];
        for (int w = 1; w < WARPS; ++w) argmin_step(bv, bi, s_wval[w], s_widx[w]);
        s_jmin = bi;
        s_min = bv;
        const int nxt = s_row4col[bi];
        s_sink = nxt < 0 ? bi : -1;
        if (nxt >= 0) s_i = nxt;
      }
      __syncthreads();
      if (j == s_jmin) rem = false;
      if (s_sink >= 0) break;
    }

    // --- dual updates ----------------------------------------------------
    const float mv = s_min;
    s_spc[j] = spc;
    s_path[j] = path;
    __syncthreads();
    float u = s_u[j], v = s_v[j];
    if (j < n) {
      if (j == cur) {
        u = u + mv;
      } else if (s_sr[j]) {
        u = u + (mv - s_spc[s_col4row[j]]);
      }
      if (!rem) v = v - (mv - spc);
    }
    __syncthreads();
    s_u[j] = u;
    s_v[j] = v;

    // --- augment along the predecessor path ------------------------------
    if (j == 0) {
      int jj = s_sink;
      while (true) {
        const int i = s_path[jj];
        s_row4col[jj] = i;
        const int next_j = s_col4row[i];
        s_col4row[i] = jj;
        if (i == cur) break;
        jj = next_j;
      }
    }
    __syncthreads();
  }
  if (j < n) col4row_out[static_cast<size_t>(blockIdx.x) * n + j] = s_col4row[j];
}

}  // namespace

extern "C" int tscd_linear_sum_assignment(const void* cost, void* col4row,
                                          int B, int n, void* stream) {
  if (n < 1 || n > NMAX || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * n * n;
  cudaError_t err = cudaFuncSetAttribute(
      linear_sum_assignment_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_sum_assignment_kernel<<<B, NMAX, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(col4row), n);
  return static_cast<int>(cudaGetLastError());
}
