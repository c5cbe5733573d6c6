// Fused dual-branch (cls/reg) proposal attention.
//
// Replaces tscd_tpu/ops/pallas/fused_attention.py (_fused_forward ->
// _kernel). Per (batch, head):
//   lc = 25 * qc^ . kc^ * score[k] + mask[k],  lr = 25 * qr^ . kr^ + mask[k]
//   attn = (softmax(lc) + softmax(lr)) / 2
//   out_c = attn @ vc,  out_r = attn @ vr
// with q^, k^ the L2-normalised rows and mask = -1e9 on invalid keys.
// `attn` is written out: the round-2 pooling of the caller reads it.
//
// Layout: q (B, H, NQ, D), k/v (B, H, NK, D), score/valid (B, NK),
// out (B, H, NQ, D), attn (B, H, NQ, NK); all fp32, valid uint8.
//
// Design: a block takes TQ = 8 query rows of one (batch, head), one warp
// per row. Keys stream through shared memory in tiles of 32, one key per
// lane. Pass 1 keeps a running max and sum of each softmax per row;
// pass 2 recomputes the logits, writes attn once and accumulates attn@V
// for both branches (lane owns output dims lane, lane+32, ...). Logits
// and softmax stay fp32 (FMA on the CUDA cores; wgmma/TMA are later
// work). At the main-path shape (B=1, H=4, NQ=50, NK=1600, D=64) the
// kernel moves 8.0 MB, most of it the k/v reads and the attn write
// (2.40 us at 3.35 TB/s), and does 0.164 GFLOP (2.45 us of fp32 FMA at
// 67 TFLOP/s), so operations bound it, by a hair; with 28 blocks on 132
// SMs it is latency bound in practice.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 8;
constexpr int TK = 32;
constexpr int THREADS = TQ * 32;
constexpr int DMAX = 128;
constexpr int DREG = DMAX / 32;
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Loads keys [k0, k0 + TK) of both branches (and their values) into
// shared memory; keys past NK are zero.
__device__ void load_tile(const float* kc, const float* kr, const float* vc,
                          const float* vr, float* skc, float* skr, float* svc,
                          float* svr, int k0, int NK, int D, bool with_v) {
  const int ld = D + 1;
  for (int idx = threadIdx.x; idx < TK * D; idx += THREADS) {
    const int kk = idx / D, t = idx - kk * D;
    const int key = k0 + kk;
    const bool in = key < NK;
    const size_t g = static_cast<size_t>(key) * D + t;
    skc[kk * ld + t] = in ? kc[g] : 0.f;
    skr[kk * ld + t] = in ? kr[g] : 0.f;
    if (with_v) {
      svc[kk * D + t] = in ? vc[g] : 0.f;
      svr[kk * D + t] = in ? vr[g] : 0.f;
    }
  }
}

// Both logits of this warp's query row against the lane's key.
__device__ __forceinline__ void logits(const float* sq_c, const float* sq_r,
                                       const float* skc, const float* skr,
                                       int kk, int D, float scale, float score,
                                       float neg, float& lc, float& lr) {
  const int ld = D + 1;
  float dc = 0.f, dr = 0.f, nc = 0.f, nr = 0.f;
  for (int t = 0; t < D; ++t) {
    const float a = skc[kk * ld + t];
    const float b = skr[kk * ld + t];
    dc = fmaf(sq_c[t], a, dc);
    dr = fmaf(sq_r[t], b, dr);
    nc = fmaf(a, a, nc);
    nr = fmaf(b, b, nr);
  }
  dc = dc / fmaxf(sqrtf(nc), 1e-12f);
  dr = dr / fmaxf(sqrtf(nr), 1e-12f);
  lc = dc * scale * score + neg;
  lr = dr * scale + neg;
}

__global__ void __launch_bounds__(THREADS)
fused_dual_attention_kernel(const float* __restrict__ qc,
                            const float* __restrict__ kc,
                            const float* __restrict__ vc,
                            const float* __restrict__ qr,
                            const float* __restrict__ kr,
                            const float* __restrict__ vr,
                            const float* __restrict__ score,
                            const unsigned char* __restrict__ valid,
                            float* __restrict__ out_c,
                            float* __restrict__ out_r,
                            float* __restrict__ attn, int H, int NQ, int NK,
                            int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq_c = smem;                 // TQ x D normalised queries
  float* sq_r = sq_c + TQ * D;
  float* skc = sq_r + TQ * D;         // TK x (D+1) keys
  float* skr = skc + TK * ld;
  float* svc = skr + TK * ld;         // TK x D values
  float* svr = svc + TK * D;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.y * TQ + warp;
  const bool row_ok = row < NQ;  // uniform within the warp

  const size_t qoff = static_cast<size_t>(bh) * NQ * D;
  const size_t koff = static_cast<size_t>(bh) * NK * D;
  kc += koff; kr += koff; vc += koff; vr += koff;
  score += static_cast<size_t>(b) * NK;
  valid += static_cast<size_t>(b) * NK;
  float* my_qc = sq_c + warp * D;
  float* my_qr = sq_r + warp * D;

  if (row_ok) {
    const float* a = qc + qoff + static_cast<size_t>(row) * D;
    const float* c = qr + qoff + static_cast<size_t>(row) * D;
    float ssc = 0.f, ssr = 0.f;
    for (int t = lane; t < D; t += 32) {
      ssc = fmaf(a[t], a[t], ssc);
      ssr = fmaf(c[t], c[t], ssr);
    }
    const float nc = fmaxf(sqrtf(warp_sum(ssc)), 1e-12f);
    const float nr = fmaxf(sqrtf(warp_sum(ssr)), 1e-12f);
    for (int t = lane; t < D; t += 32) {
      my_qc[t] = a[t] / nc;
      my_qr[t] = c[t] / nr;
    }
  }

  // pass 1: running max / sum of both softmaxes
  float mc = -INFINITY, sc = 0.f, mr = -INFINITY, sr = 0.f;
  for (int k0 = 0; k0 < NK; k0 += TK) {
    __syncthreads();
    load_tile(kc, kr, vc, vr, skc, skr, svc, svr, k0, NK, D, false);
    __syncthreads();
    if (!row_ok) continue;
    const int key = k0 + lane;
    float lc = -INFINITY, lr = -INFINITY;
    if (key < NK)
      logits(my_qc, my_qr, skc, skr, lane, D, scale, score[key],
             valid[key] ? 0.f : NEG, lc, lr);
    const float nmc = fmaxf(mc, warp_max(lc));
    const float nmr = fmaxf(mr, warp_max(lr));
    sc = sc * expf(mc - nmc) + warp_sum(key < NK ? expf(lc - nmc) : 0.f);
    sr = sr * expf(mr - nmr) + warp_sum(key < NK ? expf(lr - nmr) : 0.f);
    mc = nmc;
    mr = nmr;
  }

  // pass 2: attn written once, attn@V for both branches
  float acc_c[DREG], acc_r[DREG];
#pragma unroll
  for (int i = 0; i < DREG; ++i) acc_c[i] = acc_r[i] = 0.f;
  float* attn_row = attn + (static_cast<size_t>(bh) * NQ + row) * NK;
  for (int k0 = 0; k0 < NK; k0 += TK) {
    __syncthreads();
    load_tile(kc, kr, vc, vr, skc, skr, svc, svr, k0, NK, D, true);
    __syncthreads();
    if (!row_ok) continue;
    const int key = k0 + lane;
    float p = 0.f;
    if (key < NK) {
      float lc, lr;
      logits(my_qc, my_qr, skc, skr, lane, D, scale, score[key],
             valid[key] ? 0.f : NEG, lc, lr);
      p = 0.5f * (expf(lc - mc) / sc + expf(lr - mr) / sr);
      attn_row[key] = p;
    }
    for (int j = 0; j < TK; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
      for (int i = 0; i < DREG; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          acc_c[i] = fmaf(pj, svc[j * D + dd], acc_c[i]);
          acc_r[i] = fmaf(pj, svr[j * D + dd], acc_r[i]);
        }
      }
    }
  }
  if (row_ok) {
    const size_t o = qoff + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < DREG; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        out_c[o + dd] = acc_c[i];
        out_r[o + dd] = acc_r[i];
      }
    }
  }
}

}  // namespace

extern "C" int tscd_fused_dual_attention(
    const void* qc, const void* kc, const void* vc, const void* qr,
    const void* kr, const void* vr, const void* score, const void* valid,
    void* out_c, void* out_r, void* attn, int B, int H, int NQ, int NK, int D,
    float scale, void* stream) {
  if (D < 1 || D > DMAX || B < 1 || H < 1 || NQ < 1 || NK < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * TQ * D + 2 * TK * (D + 1) + 2 * TK * D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dual_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (NQ + TQ - 1) / TQ);
  fused_dual_attention_kernel<<<grid, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qc), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const float*>(qr),
      static_cast<const float*>(kr), static_cast<const float*>(vr),
      static_cast<const float*>(score),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out_c),
      static_cast<float*>(out_r), static_cast<float*>(attn), H, NQ, NK, D,
      scale);
  return static_cast<int>(cudaGetLastError());
}
