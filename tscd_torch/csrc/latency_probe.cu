// Latency, in SM clock cycles, of each kind of instruction on the
// dependent chain of one Dijkstra step of the Hungarian solver
// (hungarian.cu). No kernel of the model: chip_smoke.py runs it once to
// reckon the solver's latency bound, steps x cycles of that chain.
//
// One warp runs, for each kind, REPS instructions each of which needs the
// one before, between two clock64() reads:
//   0 lds    shared load whose address is the value it loads last
//   1 fadd   fp32 add
//   2 imad   integer multiply-add, for the chain's integer operations
//   3 redux  redux.sync.min.u32 over the warp
//   4 vote   integer compare, __ballot_sync of it and a shift, as one (the
//            solver's rare third minimum waits on a vote)
//   5 ffs    __ffs, as compiled (a ballot's lowest lane, the argmin the
//            solver does not use)
// Inputs `in` (device, int32): in[0..31] = 4 * k (byte offsets of the
// chase), in[32] = 1, in[33] = 0. Output `out` (device, int64): total
// cycles of each chain, lane 0's; the caller divides by REPS.

#include <cuda_runtime.h>

namespace {

constexpr int REPS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__global__ void latency_probe_kernel(const int* __restrict__ in,
                                     long long* __restrict__ out, int* sink) {
  __shared__ int chase[32];
  const int lane = threadIdx.x & 31;
  chase[lane] = in[lane];
  const int one = in[32], zero = in[33];
  __syncwarp();
  int acc = 0;

  int off = in[lane];
  const long long l0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k)
    off = *reinterpret_cast<const volatile int*>(
        reinterpret_cast<const char*>(chase) + off);
  const long long l1 = clock64();
  acc += off;

  float x = static_cast<float>(one), y = static_cast<float>(zero);
  const long long f0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k) x = x + y;
  const long long f1 = clock64();
  acc += static_cast<int>(x);

  int m = one + lane;
  const long long m0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k) m = m * one + zero;
  const long long m1 = clock64();
  acc += m;

  unsigned r = static_cast<unsigned>(lane + one);
  const long long r0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k)
    asm volatile("redux.sync.min.u32 %0, %0, 0xffffffff;" : "+r"(r));
  const long long r1 = clock64();
  acc += static_cast<int>(r);

  unsigned w = static_cast<unsigned>(one);
  const long long v0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k) w = __ballot_sync(FULL, w != 0u) >> 31;
  const long long v1 = clock64();
  acc += static_cast<int>(w);

  int e = one;
  const long long e0 = clock64();
#pragma unroll 64
  for (int k = 0; k < REPS; ++k) e = __ffs(e);
  const long long e1 = clock64();
  acc += e;

  if (lane == 0) {
    out[0] = l1 - l0;
    out[1] = f1 - f0;
    out[2] = m1 - m0;
    out[3] = r1 - r0;
    out[4] = v1 - v0;
    out[5] = e1 - e0;
  }
  sink[lane] = acc;     // keeps every chain live
}

}  // namespace

extern "C" int tscd_latency_probe(const void* in, void* out, void* sink,
                                  void* stream) {
  latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<long long*>(out),
      static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}
