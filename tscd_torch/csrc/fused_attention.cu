// Fused dual-branch (cls/reg) proposal attention, two routes: split over
// keys (the MCA cross form, NQ <= 128) and streaming (the self-attention
// form; its design where its kernel is, below the split's).
//
// Replaces tscd_tpu/ops/pallas/fused_attention.py (_fused_forward ->
// _kernel). Per (batch, head):
//   lc = 25 * qc^ . kc^ * score[k] + mask[k],  lr = 25 * qr^ . kr^ * fg[k] + mask[k]
//   attn = (softmax(lc) + softmax(lr)) / 2
//   out_c = attn @ vc,  out_r = attn @ vr
// with q^, k^ the L2-normalised rows and mask = -1e9 on invalid keys; fg
// (the online MSA's reg-branch guidance, aggregation.py:125-126) is 1
// where the caller passes none; both routes take one.
// `attn` is written out: the round-2 pooling of the caller reads it.
//
// Layout: q (B, H, NQ, D), k/v (B, H, NK, D), each with its last dim
// contiguous and its other three strides passed in (the caller's heads
// are transposed views of a Linear output); score/valid (B, NK)
// contiguous; out (B, H, NQ, D), attn (B, H, NQ, NK) contiguous; q, k
// and v fp32 or bf16 (all six alike), everything else fp32, valid uint8.
//
// bf16 q/k/v (the bf16 model's Linear outputs) are read as they are and
// upcast as they land in shared memory, as the Pallas kernel upcasts in
// its body (fused_attention.py:33-37): norms, logits, softmaxes and the
// outputs are fp32 as at fp32, and only the copy-in differs (8-byte
// loads of 4 values and a conversion, in place of cp.async).
//
// Bound on an H100 at the main-path shape (B=1, H=4, NQ=50, NK=1600,
// D=64): 8.0 MB moved (2.40 us at 3.35 TB/s) and 0.164 GFLOP of fp32 FMA
// (2.45 us at 67 TFLOP/s), so operations bound it, by a hair. What holds
// a kernel back at this size is parallelism and latency: one (batch,
// head) has only 50 query rows, so the work is split over keys.
//
// Design of the split route: two launches on the caller's stream.
//   split    grid (key chunks of KC = 32, B*H, query tiles of QT = 64),
//            256 threads: 50 x 4 x 1 = 200 blocks at the main path, all
//            resident at once on the 132 SMs (2 a SM). A block copies its
//            query tile, its key and value chunk of both branches, and its
//            keys' scores and mask into shared memory (cp.async, 16 bytes
//            where the strides allow), computes each vector's norm once
//            (each key's by the block that owns it), then the QT x KC
//            logits once: each half of the block takes one branch, a
//            thread 4 rows x 4 keys, float4 shared loads, 16 independent
//            accumulators. Per (row, chunk) it keeps the max m and the sum
//            s of p = exp(l - m) of both softmaxes (a shuffle over the 8
//            lanes of a row), and writes p, (m, s) and the four
//            chunk-local products p_c@v_c, p_r@v_c, p_c@v_r, p_r@v_r (a
//            thread 4 rows x 4 dims x 4 products, p key-major in shared
//            memory) to scratch.
//   combine  grid (NQ, B*H), 1024 threads, one block a query row. One warp
//            reduces the row's chunk statistics, in chunk order, to each
//            softmax's global max M and sum S, which gives every chunk
//            the factor f = exp(m - M) / S of each branch. The block then
//            writes attn = (f_c p_c + f_r p_r) / 2 and
//            out = sum over chunks of (f_c p_c@v + f_r p_r@v) / 2, the
//            chunks in 8 interleaved shares added in order.
// Two launches (and not one cooperative launch with a grid barrier),
// because the split's grid then needs no residency limit: any B, H, NQ,
// NK runs on the same code, and the logits need not outlive a block.
// The price is the scratch (p 2.6 MB and the products 10.2 MB at the
// main path, both in the 50 MB L2) and twice the value products.
// Deterministic: no atomics, and every sum across threads or chunks has
// a fixed order, so two calls give bit-identical outputs.
//
// The split route stays on fp32 FMA with accurate expf. Its work at the
// main path is 0.164 GFLOP (2.45 us on the CUDA cores) in a launch that
// takes 26 us: what holds it back is parallelism and latency over 50
// query rows, not the product rate, so the tensor cores' 3xTF32 split
// (the streaming route's, below) would add its conversions and buy
// nothing. One TF32 product alone keeps about 3 decimal digits: at a
// logit scale of 25 that moves the probabilities by about 1% relative,
// against the 1e-5 the port is checked to.
//
// Resources (nvcc -Xptxas -v, build/kernels/build.log): split 127
// registers, combine 32, no spills; dynamic shared memory 85 KiB a split
// block at D = 64 (149 KiB at D = 128), 4.4 KiB a combine block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace {

constexpr int KC = 32;          // keys a split block owns: one chunk
constexpr int QT = 64;          // query rows of a split block
constexpr int THREADS = 256;    // split block
constexpr int KL = KC / 4;      // lanes that share a row's logits
constexpr int RP = 4;           // rows a thread holds in the products
constexpr int CTHREADS = 1024;  // combine block
constexpr int DMAX = 128;
constexpr int PLD = QT + 4;     // row stride of p (key-major) in shared memory
constexpr int NPROD = 4;        // p_c@v_c, p_r@v_c, p_c@v_r, p_r@v_r
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr size_t COMBINE_SMEM_MAX = 48 * 1024;

struct Args {
  const void* q[2];             // qc, qr (fp32 or bf16)
  const void* k[2];             // kc, kr
  const void* v[2];             // vc, vr
  long long qs[2][3], ks[2][3], vs[2][3];   // strides of batch, head, row
  const float* score;
  const float* fg;              // the reg branch's key score, or null
  const unsigned char* valid;
  float* out[2];
  float* attn;
  bool vec;                     // q, k, v rows in aligned groups of 4: 4 a copy
  float4* stats;                // split scratch (B*H, NQ, nch): m_c, s_c, m_r, s_r
  float* part;                  // scratch (B*H, NQ, nch, NPROD, DP)
  float* p[2];                  // scratch (B*H, NQ, NK): exp(l - m)
  int H, NQ, NK, D, DP, DS, nch;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

__device__ __forceinline__ void axpy4(float4& acc, float s, float4 x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Copies rows x DP values into dst (fp32, row stride ld) from src (row
// stride rs); rows >= n and columns >= D land as zeros. With vec (D and
// rs multiples of 4, src aligned to 4 values) 4 values a copy, else 1.
// fp32 goes by cp.async (wait before reading); bf16 by plain loads,
// converted to fp32 as they are stored.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long rs, int rows, int n,
                                          int D, int DP, bool vec) {
  const int w = vec ? 4 : 1, per_row = DP / w;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, t = (i - r * per_row) * w;
    const bool in = r < n && t < D;
    if constexpr (std::is_same<T, float>::value) {
      cp_async(dst + r * ld + t, in ? src + r * rs + t : src, 4 * w, in);
    } else if (vec) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) {
        const uint2 u = *reinterpret_cast<const uint2*>(src + r * rs + t);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        o = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(dst + r * ld + t) = o;
    } else {
      dst[r * ld + t] = in ? __bfloat162float(src[r * rs + t]) : 0.f;
    }
  }
}

size_t split_smem(int DP, int DS) {
  return sizeof(float) * (2 * QT * DS + 2 * KC * DS + 2 * KC * DP +
                          2 * KC * PLD + 2 * (QT + KC) + 3 * KC);
}

// shared row stride of q and k: DP rounded so that DS / 4 is odd, which
// puts 8 neighbouring rows' float4 loads on distinct banks
int shared_stride(int DP) { return ((DP / 4) | 1) * 4; }

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fused_dual_attention_split(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int DS = a.DS, DP = a.DP;
  float* sq = smem;                    // [2][QT][DS] queries
  float* sk = sq + 2 * QT * DS;        // [2][KC][DS] keys
  float* sv = sk + 2 * KC * DS;        // [2][KC][DP] values
  float* sp = sv + 2 * KC * DP;        // [2][KC][PLD] p of both branches
  float* inv_q = sp + 2 * KC * PLD;    // [2][QT] 1 / |q|
  float* inv_k = inv_q + 2 * QT;       // [2][KC] 1 / |k|
  float* s_score = inv_k + 2 * KC;     // [KC] score of each key
  float* s_neg = s_score + KC;         // [KC] 0 or -1e9
  float* s_fg = s_neg + KC;            // [KC] reg score of each key (1 without one)

  const int chunk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int k0 = chunk * KC, q0 = blockIdx.z * QT;
  const int kn = min(KC, a.NK - k0), qn = min(QT, a.NQ - q0);
  const int tid = threadIdx.x;

  for (int br = 0; br < 2; ++br) {
    const T* q = static_cast<const T*>(a.q[br]);
    const T* k = static_cast<const T*>(a.k[br]);
    const T* v = static_cast<const T*>(a.v[br]);
    load_rows(sq + br * QT * DS, DS,
              q + b * a.qs[br][0] + h * a.qs[br][1] + q0 * a.qs[br][2],
              a.qs[br][2], QT, qn, a.D, DP, a.vec);
    load_rows(sk + br * KC * DS, DS,
              k + b * a.ks[br][0] + h * a.ks[br][1] + k0 * a.ks[br][2],
              a.ks[br][2], KC, kn, a.D, DP, a.vec);
    load_rows(sv + br * KC * DP, DP,
              v + b * a.vs[br][0] + h * a.vs[br][1] + k0 * a.vs[br][2],
              a.vs[br][2], KC, kn, a.D, DP, a.vec);
  }
  if (tid < KC) {
    const bool in = tid < kn;
    const size_t key = static_cast<size_t>(b) * a.NK + k0 + tid;
    s_score[tid] = in ? a.score[key] : 0.f;
    s_neg[tid] = in && a.valid[key] ? 0.f : NEG;
    s_fg[tid] = in && a.fg ? a.fg[key] : 1.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // each vector's norm once: one thread a query row or key
  for (int i = tid; i < 2 * (QT + KC); i += THREADS) {
    const bool is_q = i < 2 * QT;
    const float* x = is_q ? sq + i * DS : sk + (i - 2 * QT) * DS;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < DP; t += 4) {
      const float4 v = ld4(x + t);
      s.x = fmaf(v.x, v.x, s.x);
      s.y = fmaf(v.y, v.y, s.y);
      s.z = fmaf(v.z, v.z, s.z);
      s.w = fmaf(v.w, v.w, s.w);
    }
    const float inv = 1.f / fmaxf(sqrtf((s.x + s.y) + (s.z + s.w)), 1e-12f);
    if (is_q) inv_q[i] = inv;
    else inv_k[i - 2 * QT] = inv;
  }
  __syncthreads();

  // logits of one branch a half block: rows ty + 16 i, keys tx + KL j
  const int br = tid / (THREADS / 2), t2 = tid - br * (THREADS / 2);
  const int tx = t2 % KL, ty = t2 / KL;
  float l[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) l[i][j] = 0.f;
  for (int t = 0; t < DP; t += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = ld4(sq + (br * QT + ty + 16 * i) * DS + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = ld4(sk + (br * KC + tx + KL * j) * DS + t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) l[i][j] = dot4(qv[i], kv[j], l[i][j]);
  }

  // scaled and masked logits; keys past NK are -inf (p = 0)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = tx + KL * j;
    const bool in = kk < kn;
    const float sc = br == 0 ? s_score[kk] : s_fg[kk];
    const float ng = s_neg[kk];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = l[i][j] * inv_q[br * QT + ty + 16 * i] * inv_k[br * KC + kk] * a.scale * sc;
      l[i][j] = in ? x + ng : -INFINITY;
    }
  }

  // per (row, chunk): max and sum of the softmax over the KL lanes of a row
  const size_t row_base = static_cast<size_t>(bh) * a.NQ + q0;
  float2* stats = reinterpret_cast<float2*>(a.stats);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    float mx = fmaxf(fmaxf(l[i][0], l[i][1]), fmaxf(l[i][2], l[i][3]));
    for (int o = 1; o < KL; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    float sm = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[i][j] = expf(l[i][j] - mx);
      sm += l[i][j];
    }
    for (int o = 1; o < KL; o <<= 1) sm += __shfl_xor_sync(FULL, sm, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + KL * j;
      sp[(br * KC + kk) * PLD + row] = l[i][j];
      if (row < qn && kk < kn)
        a.p[br][(row_base + row) * a.NK + k0 + kk] = l[i][j];
    }
    if (tx == 0 && row < qn)
      stats[((row_base + row) * a.nch + chunk) * 2 + br] = make_float2(mx, sm);
  }
  __syncthreads();

  // chunk-local products: rows RP py + i, dims c.. c + 3
  const int px = tid & 15, py = tid >> 4;
  if (RP * py >= qn) return;
  for (int c = 4 * px; c < DP; c += 64) {
    float4 o[NPROD][RP];
#pragma unroll
    for (int pr = 0; pr < NPROD; ++pr)
#pragma unroll
      for (int i = 0; i < RP; ++i) o[pr][i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 vc = ld4(sv + kk * DP + c);
      const float4 vr = ld4(sv + (KC + kk) * DP + c);
      const float4 x = ld4(sp + kk * PLD + RP * py), y = ld4(sp + (KC + kk) * PLD + RP * py);
      const float pc[RP] = {x.x, x.y, x.z, x.w}, pr[RP] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        axpy4(o[0][i], pc[i], vc);
        axpy4(o[1][i], pr[i], vc);
        axpy4(o[2][i], pc[i], vr);
        axpy4(o[3][i], pr[i], vr);
      }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int row = RP * py + i;
      if (row >= qn) break;
      float* dst = a.part + ((row_base + row) * a.nch + chunk) * NPROD * DP + c;
#pragma unroll
      for (int pr = 0; pr < NPROD; ++pr)
        *reinterpret_cast<float4*>(dst + pr * DP) = o[pr][i];
    }
  }
}

__global__ void __launch_bounds__(CTHREADS)
fused_dual_attention_combine(const Args a) {
  extern __shared__ float cs[];
  const int nch = a.nch, D = a.D, DP = a.DP;
  float* f = cs;                 // [2][nch] exp(m - M) / S of each chunk
  float* red = cs + 2 * nch;     // [G][2D] sums over a share of the chunks
  const size_t r = static_cast<size_t>(blockIdx.y) * a.NQ + blockIdx.x;
  const int tid = threadIdx.x;

  if (tid < 32) {
    const float4* __restrict__ st = a.stats + r * nch;
    float mc = -INFINITY, mr = -INFINITY;
    for (int j = tid; j < nch; j += 32) {
      const float4 s = st[j];
      mc = fmaxf(mc, s.x);
      mr = fmaxf(mr, s.z);
    }
    mc = warp_max(mc);
    mr = warp_max(mr);
    float sc = 0.f, sr = 0.f;
    for (int j = tid; j < nch; j += 32) {
      const float4 s = st[j];
      sc = fmaf(s.y, expf(s.x - mc), sc);
      sr = fmaf(s.w, expf(s.z - mr), sr);
    }
    sc = warp_sum(sc);
    sr = warp_sum(sr);
    for (int j = tid; j < nch; j += 32) {
      const float4 s = st[j];
      f[j] = expf(s.x - mc) / sc;
      f[nch + j] = expf(s.z - mr) / sr;
    }
  }
  __syncthreads();

  const float* __restrict__ pc = a.p[0] + r * a.NK;
  const float* __restrict__ pr = a.p[1] + r * a.NK;
  float* __restrict__ at = a.attn + r * a.NK;
#pragma unroll 4
  for (int k = tid; k < a.NK; k += CTHREADS) {
    const int j = k / KC;
    at[k] = 0.5f * fmaf(pc[k], f[j], pr[k] * f[nch + j]);
  }

  // out = sum over chunks, in G interleaved shares, then the shares in order
  const int n2 = 2 * D, G = CTHREADS / n2, g = tid / n2, o = tid - g * n2;
  if (g < G) {
    const int br = o / D, d = o - br * D;
    const float* __restrict__ pp = a.part + r * nch * NPROD * DP + 2 * br * DP + d;
    float acc = 0.f;
#pragma unroll 8
    for (int j = g; j < nch; j += G) {
      const float* pj = pp + static_cast<size_t>(j) * NPROD * DP;
      acc = fmaf(f[j], pj[0], fmaf(f[nch + j], pj[DP], acc));
    }
    red[g * n2 + o] = acc;
  }
  __syncthreads();
  if (tid < n2) {
    float acc = 0.f;
    for (int s = 0; s < G; ++s) acc += red[s * n2 + tid];
    const int br = tid / D, d = tid - br * D;
    a.out[br][r * D + d] = 0.5f * acc;
  }
}

// ---------------------------------------------------------------------------
// The streaming route: the self-attention form (NQ > 128), whose split
// scratch would grow as NQ x NK x D. A block owns a (batch, head, tile of
// `rows` query rows) and streams the keys through shared memory twice:
//   pass 1  per key tile of KT = 32 keys, both branches' logits, then each
//           row's running max and sum of exp2 of both softmaxes (each lane
//           its own keys' partials, combined over the quad and the warps
//           that share the rows at the end);
//   pass 2  the logits again; p = exp2(l - M) / S of both branches, attn =
//           (p_c + p_r) / 2 written once to device memory, and attn @ v_c,
//           attn @ v_r accumulated in registers over the tiles.
// Each row's (M, S) stays on chip from pass 1 into pass 2: no scratch.
//
// Work: 8 q k d flops a head for the function, 12 with pass 2's recompute.
// Bound on an H100 at OVIS YOLOV++'s q = k = 16000, h 4, d 64: 5.24e11
// flops, each product done as 3 TF32 products on the tensor cores (below):
// 3.18 ms at 495 TFLOP/s, against 4.1 GB of attn written (1.22 ms at 3.35
// TB/s) and 4.1e9 exp2 (about 1 ms at 16 a clock a SM): the tensor cores
// bound it. The design's own floor, with the recompute, is 1.5x that:
// 4.77 ms. (The fp32 FMA bound of the same work is 7.8 ms.)
//
// The design, by what held the earlier FMA kernel back:
//  1. Tensor cores, 3xTF32. Both products (q.k of both passes, attn @ v)
//     run as mma.sync.m16n8k8 .tf32 with fp32 accumulators. Each fp32
//     operand x splits into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
//     hi), and a product is lo.hi' + hi.lo' + hi.hi' (small terms first);
//     lo.lo' (2^-22 relative) is dropped. The split keeps about 2^-21 of
//     each product, against fp32's 2^-24: modelled on the CPU at q = k =
//     960, d 64, its outputs sit 2.4e-6 from float64 (attn 3.9e-7), as
//     fp32 FMA's do (2.3e-6), where one TF32 product is 1.8e-3 off and
//     misses the port's 1e-5 (tests/test_torch_port_attention_stream.py,
//     which holds the model to JAX's reference). The tensor cores round
//     their sums toward zero, which over the 2000 k-steps of attn @ v at
//     16000 keys drifts by 1e-4: each tile's attn @ v is summed from zero
//     and added to the running output by an fp32 add (round to nearest).
//     bf16 q/k/v are exact in TF32 (lo = 0): their logits take one product
//     and attn @ v two.
//     mma.sync rather than wgmma: the logits' accumulators are attn @ v's
//     A operand as they stand (the key order below), where wgmma's TF32
//     needs both operands K-major in shared memory, so attn and v (whose
//     copy cannot transpose) would go through shared memory each tile, and
//     the split would need hi and lo copies of every tile there.
//  2. Reuse and residency. A warp owns 16 query rows of both branches (so
//     attn combines in registers) and, of each key tile, NT / KW of its 4
//     n-tiles: a block is rows / 16 row groups x KW key slices, the
//     slices' sums combined in shared memory in slice order. The rule, a
//     function of the shape (stream_plan): rows the largest of 128 (32
//     past d 64, for shared memory), 64, 32, 16 whose blocks still cover
//     9 in 10 SMs (10 B H ceil(NQ / rows) >= 9 x the SM count), else 16;
//     KW = min(4, 128 / rows). 128 rows x 1 slice at 8000 and 16000 (a key
//     tile feeds 8 warps, each key read from L2 once a 128 rows); 32 rows
//     x 4 slices at YOLOV-L's 960 (120 blocks of 8 warps, which the card
//     ran faster than 240 blocks of 16 rows x 4: a tile's copy and key
//     factors are shared by twice the warps).
//  3. Asynchronous copies. Key tiles (and value tiles in pass 2) of both
//     branches in a ring of 2 stages filled by cp.async (16 bytes fp32, 8
//     bf16) where `vec` allows, row4's plain loads where it does not; tile
//     i + 1 is in flight while tile i is multiplied. Key rows are stored
//     permuted (key_row) so that the fragments' loads (ldmatrix for fp32
//     keys) are free of bank conflicts and a lane's logits are 4
//     consecutive keys. The queries are split into hi and lo once, into
//     shared memory, and read by ldmatrix.
//  4. Exponentials. ex2.approx with log2(e) folded into each key's factor
//     (25 log2(e) score / |k|) and into the mask; the two branches'
//     probabilities combine in the registers that hold them, and attn
//     leaves as 16-byte streaming stores (st.global.cs) of 4 keys a lane
//     (8 bytes where a warp owns one n-tile of a tile), behind which the
//     next products run. Each key's factor takes 2 or 4 threads (shuffle
//     sums) between the tile's two barriers.
//  5. What the route guarantees. No scratch; no atomics; every sum across
//     lanes, warps and tiles in a fixed order and the tensor cores' sums
//     fixed, so two calls are bit-identical. A row whose keys are all
//     invalid sees equal logits (-1e9 log2(e) absorbs the q.k term) and is
//     uniform; one valid key takes all the mass; keys past NK get p = 0
//     (factor 0, mask -inf, rows of zeros).
// The inverse norms, the x 25, the score or fg and the mask stay an fp32
// epilogue on the raw q.k: l2 = (q.k / |q|) * f[k] + mask[k].
// Shared memory (fp32): the split queries 2 x 2 x rows x (DPAD + 4)
// floats, the ring 2 x 4 x KT x (DPAD + 4): 206.4 KiB at 128 rows, d 64
// (1 block a SM); 104.4 KiB at 32 rows, d 64; 200.4 KiB at 32 rows, d 128.
// Registers (ptxas, build/kernels/build.log): 237 at d 64 with one key
// slice, 166 with four, 128 at d 32 (a 48-byte stack frame), 254 at d 128;
// no spills.
constexpr int KT = 32;                  // keys of a streamed tile
constexpr int NT = KT / 8;              // mma n-tiles of a tile's logits
constexpr int STAGES = 2;               // the ring: tiles of 2 keys and 2 values a stage
constexpr int MAX_ROWS = 128;           // query rows of the largest block
constexpr int MAX_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;

struct StreamPlan {
  int rows, kw;                         // query rows a block, key slices (warps a row group)
};

int stream_max_rows(int DPAD) { return DPAD > 64 ? 32 : MAX_ROWS; }

// The block's rows and key slices at this shape (the rule of note 2).
StreamPlan stream_plan(int B, int H, int NQ, int DPAD, int sms) {
  int rows = stream_max_rows(DPAD);
  while (rows > 16 && 10 * static_cast<long long>((NQ + rows - 1) / rows) * B * H < 9 * sms)
    rows /= 2;
  return {rows, std::min(4, MAX_ROWS / rows)};
}

// dynamic shared memory: [queries: 2 branches x hi (, lo) x rows x (DPAD +
// 4) words][ring: STAGES x 4 x KT x LD of T][key factors 2 KT][masks
// KT][per-warp row statistics warps x 2 x 16 float2]; after pass 2 the
// front holds each warp's outputs, warps x 2 x 16 x (DPAD + 8) floats
template <typename T>
size_t stream_smem(int DPAD, int rows, int kw) {
  const size_t ld = DPAD + 16 / sizeof(T), warps = rows / 16 * kw;
  const size_t parts = std::is_same<T, float>::value ? 2 : 1;
  const size_t main = 4 * (DPAD + 4) * 2 * parts * rows + sizeof(T) * ld * STAGES * 4 * KT +
                      4 * 3 * KT + 8 * warps * 2 * 16;
  return std::max(main, 4 * warps * 2 * 16 * (DPAD + 8));
}

// Shared row of key r of a tile: row 8 j + n holds col_key(j, n), the key
// whose logit lands in column n of n-tile j. Lane t of a quad then holds
// keys 4t .. 4t + 3 (n-tiles 0, 1) and 16 + 4t .. 19 + 4t (2, 3) of a row.
__host__ __device__ constexpr int key_row(int r) {
  return 8 * (2 * (r / 16) + (r % 4) / 2) + 2 * ((r % 16) / 4) + r % 2;
}
__device__ __forceinline__ int col_key(int j, int n) {
  return 16 * (j / 2) + 4 * (n / 2) + 2 * (j % 2) + n % 2;
}

template <typename T> __device__ __forceinline__ float4 get4(const T* p);
template <> __device__ __forceinline__ float4 get4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 get4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// values t .. t + 3 of row r (row stride rs), zeros past n rows or D columns;
// with vec (D and the strides multiples of 4, aligned) one 4-value load
template <typename T>
__device__ __forceinline__ float4 row4(const T* src, long long rs, int r, int t, int n,
                                       int D, bool vec) {
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= n || t >= D) return o;
  const T* p = src + r * rs + t;
  if (vec) return get4(p);
  o.x = ldf(p);
  if (t + 1 < D) o.y = ldf(p + 1);
  if (t + 2 < D) o.z = ldf(p + 2);
  if (t + 3 < D) o.w = ldf(p + 3);
  return o;
}

__device__ __forceinline__ void store4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(d) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// 4 values by cp.async: 16 bytes of fp32, 8 of bf16; zeros where !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 8 : 0) : "memory");
}

// the KT rows of a key or value tile (row stride rs; rows >= n and columns
// >= D as zeros) into dst, row r at key_row(r) (row stride DPAD + 16
// bytes); by cp.async where vec allows, else by plain loads
template <typename T, int DPAD>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long rs, int n, int D,
                                          bool vec) {
  constexpr int LD = DPAD + 16 / static_cast<int>(sizeof(T)), G = DPAD / 4;
  for (int i = threadIdx.x; i < KT * G; i += blockDim.x) {
    const int r = i / G, c = 4 * (i - r * G);
    T* d = dst + key_row(r) * LD + c;
    if (vec) {
      const bool in = r < n && c < D;
      cp_async4(d, in ? src + r * rs + c : src, in);
    } else {
      store4(d, row4(src, rs, r, c, n, D, false));
    }
  }
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// x = hi + lo, both TF32 (rounded to nearest, ties away); EXACT (x from
// bf16, 8 mantissa bits): hi = x, lo = 0
template <bool EXACT>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// four 8 x 4 word matrices of shared memory, lane l giving row l & 7 of
// matrix l >> 3; lane l receives word l & 3 of row l >> 2 of each
__device__ __forceinline__ void ldsm4(unsigned r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm2(unsigned r[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in the 3xTF32 split, the small products first; a factor that
// is exact in TF32 drops the product of its lo
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float c[4], const unsigned ah[4], const unsigned al[4],
                                     const unsigned bh[2], const unsigned bl[2]) {
  if (!EXACT_A) mma_tf32(c, al, bh);
  if (!EXACT_B) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A key tile's inputs besides its rows, for the (branch, key) pair p =
// tid / L of the 2 KT (L = blockDim.x / 2 KT threads a pair), loaded a
// tile ahead of their use
struct KeyMeta {
  float s;          // the key's score (cls) or fg (reg, 1 without one); 0 past NK
  bool valid;
};

__device__ __forceinline__ KeyMeta key_meta(const Args& a, int b, int k0, int kn) {
  const int p = threadIdx.x / (blockDim.x / (2 * KT)), br = p / KT, r = p % KT;
  const size_t key = static_cast<size_t>(b) * a.NK + k0 + r;
  const bool in = r < kn;
  return {!in ? 0.f : br == 0 ? a.score[key] : a.fg ? a.fg[key] : 1.f, in && a.valid[key]};
}

// each key's factor 25 log2(e) s / |k| of both branches (0 past kn) and
// its mask (0 or -1e9 log2(e); -inf past kn), from the landed tile: a
// (branch, key) pair takes L = 2 or 4 adjacent lanes, each DPAD / L dims
template <typename T, int DPAD>
__device__ __forceinline__ void key_factors(float* kf, float* neg, const T* stage,
                                            const KeyMeta& m, int kn, float kscale) {
  constexpr int LD = DPAD + 16 / static_cast<int>(sizeof(T));
  const int L = blockDim.x / (2 * KT), p = threadIdx.x / L, part = threadIdx.x % L;
  const int br = p / KT, r = p % KT, n = DPAD / L;
  const T* x = stage + br * KT * LD + key_row(r) * LD + part * n;
  float s0 = 0.f, s1 = 0.f;
  for (int d = 0; d < n; d += 4) {
    const float4 v = get4(x + d);
    s0 = fmaf(v.x, v.x, fmaf(v.y, v.y, s0));
    s1 = fmaf(v.z, v.z, fmaf(v.w, v.w, s1));
  }
  float ss = s0 + s1;
  for (int o = 1; o < L; o <<= 1) ss += __shfl_xor_sync(FULL, ss, o);
  if (part == 0) {
    const bool in = r < kn;
    kf[p] = in ? 1.f / fmaxf(sqrtf(ss), 1e-12f) * kscale * m.s : 0.f;
    if (br == 0) neg[r] = in ? (m.valid ? 0.f : NEG * LOG2E) : -INFINITY;
  }
}

// the K and (pass 2) V tiles of keys k0 .. k0 + kn of both branches into
// a stage of the ring, as one cp.async group
template <typename T, int DPAD>
__device__ __forceinline__ void issue_tile(T* stage, const T* const kp[2], const T* const vp[2],
                                           const Args& a, int k0, int kn, bool values) {
  constexpr int TILE = KT * (DPAD + 16 / static_cast<int>(sizeof(T)));
  for (int c = 0; c < 2; ++c)
    copy_tile<T, DPAD>(stage + c * TILE, kp[c] + k0 * a.ks[c][2], a.ks[c][2], kn, a.D, a.vec);
  if (values)
    for (int c = 0; c < 2; ++c)
      copy_tile<T, DPAD>(stage + (2 + c) * TILE, vp[c] + k0 * a.vs[c][2], a.vs[c][2], kn, a.D,
                         a.vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the raw q.k of the warp's 16 rows (row group rg) and its NJ n-tiles j0
// .. j0 + NJ - 1 of the tile, both branches
template <typename T, int DPAD, int NJ>
__device__ __forceinline__ void tile_logits(float S[2][NJ][4], const unsigned* sq, int rows,
                                            const T* stage, int rg, int j0, int lane) {
  constexpr int LD = DPAD + 16 / static_cast<int>(sizeof(T)), TILE = KT * LD, LDQ = DPAD + 4;
  constexpr bool EXACT = !std::is_same<T, float>::value;
  constexpr int QPARTS = EXACT ? 1 : 2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[br][jj][e] = 0.f;
  // ldmatrix rows: A (16 rows x 8 dims) matrix l >> 3 = (rows + 8 bit 0, dims
  // + 4 bit 1); B (8 keys x 8 dims of n-tiles j, j + 1) = (dims + 4 bit 0, keys + 8 bit 1)
  const unsigned* qa = sq + (16 * rg + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDQ + 4 * (lane >> 4);
  const T* kb = stage + (8 * (j0 + (lane >> 4)) + (lane & 7)) * LD + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < DPAD / 8; ++kk) {
#pragma unroll
    for (int br = 0; br < 2; ++br) {
      unsigned ah[4], al[4] = {0u, 0u, 0u, 0u};
      ldsm4(ah, qa + br * QPARTS * rows * LDQ + 8 * kk);
      if (!EXACT) ldsm4(al, qa + (br * QPARTS + 1) * rows * LDQ + 8 * kk);
#pragma unroll
      for (int jj = 0; jj < NJ; jj += 2) {
        unsigned bh[4], bl[4];
        if constexpr (EXACT) {
          const T* p = stage + br * TILE + (8 * (j0 + jj) + g) * LD + 8 * kk + t;
#pragma unroll
          for (int u = 0; u < (NJ > 1 ? 4 : 2); ++u)
            split<true>(ldf(p + (u >> 1) * 8 * LD + (u & 1) * 4), bh[u], bl[u]);
        } else {
          unsigned raw[4];
          if (NJ > 1) ldsm4(raw, kb + br * TILE + 8 * kk + 8 * jj * LD);
          else ldsm2(raw, kb + br * TILE + 8 * kk);
#pragma unroll
          for (int u = 0; u < (NJ > 1 ? 4 : 2); ++u) split<false>(__uint_as_float(raw[u]), bh[u], bl[u]);
        }
        mma3<EXACT, EXACT>(S[br][jj], ah, al, bh, bl);
        if (NJ > 1) mma3<EXACT, EXACT>(S[br][jj + 1], ah, al, bh + 2, bl + 2);
      }
    }
  }
}

template <typename T, int DPAD, int KW>
__global__ void __launch_bounds__(32 * MAX_WARPS)
fused_dual_attention_stream(const Args a) {
  constexpr int LD = DPAD + 16 / static_cast<int>(sizeof(T)), TILE = KT * LD, KS = DPAD / 8;
  constexpr int LDQ = DPAD + 4, LDO = DPAD + 8, NJ = NT / KW;
  constexpr bool EXACT = !std::is_same<T, float>::value;
  constexpr int QPARTS = EXACT ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, rows = warps / KW * 16;
  unsigned* sq = reinterpret_cast<unsigned*>(smem_raw);     // [2][QPARTS][rows][LDQ] hi, lo
  T* ring = reinterpret_cast<T*>(sq + 2 * QPARTS * rows * LDQ);   // [STAGES][kc, kr, vc, vr][KT][LD]
  float* kf = reinterpret_cast<float*>(ring + STAGES * 4 * TILE);  // [2][KT]
  float* neg = kf + 2 * KT;                                 // [KT]
  float2* stats = reinterpret_cast<float2*>(neg + KT);      // [warps][2][16]
  float* so = reinterpret_cast<float*>(smem_raw);           // [warps][2][16][LDO] after pass 2

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * rows, qn = min(rows, a.NQ - q0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rg = w / KW, j0 = (w % KW) * NJ;    // the warp's 16 rows and n-tiles of each tile
  const size_t row0 = static_cast<size_t>(bh) * a.NQ + q0;
  const int nkt = (a.NK + KT - 1) / KT;
  const float kscale = a.scale * LOG2E;
  const T* kp[2];
  const T* vp[2];
  float rf[2][2];                               // 1 / |q| of rows g, g + 8 of both branches
  for (int c = 0; c < 2; ++c) {
    const T* q = static_cast<const T*>(a.q[c]) + b * a.qs[c][0] + h * a.qs[c][1] +
                 q0 * a.qs[c][2];
    kp[c] = static_cast<const T*>(a.k[c]) + b * a.ks[c][0] + h * a.ks[c][1];
    vp[c] = static_cast<const T*>(a.v[c]) + b * a.vs[c][0] + h * a.vs[c][1];
    // the queries split into TF32 hi and lo, once
    for (int i = tid; i < rows * (DPAD / 4); i += blockDim.x) {
      const int r = i / (DPAD / 4), col = 4 * (i - r * (DPAD / 4));
      const float4 v = row4(q, a.qs[c][2], r, col, qn, a.D, a.vec);
      uint4 hi, lo;
      split<EXACT>(v.x, hi.x, lo.x);
      split<EXACT>(v.y, hi.y, lo.y);
      split<EXACT>(v.z, hi.z, lo.z);
      split<EXACT>(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(sq + (c * QPARTS * rows + r) * LDQ + col) = hi;
      if (!EXACT) *reinterpret_cast<uint4*>(sq + ((c * QPARTS + 1) * rows + r) * LDQ + col) = lo;
    }
    // lanes 16 c .. 16 c + 15: the norms of the row group's rows of branch c
    float s0 = 0.f, s1 = 0.f;
    if ((lane >> 4) == c)
      for (int d = 0; d < DPAD; d += 4) {
        const float4 v = row4(q, a.qs[c][2], 16 * rg + (lane & 15), d, qn, a.D, a.vec);
        s0 = fmaf(v.x, v.x, fmaf(v.y, v.y, s0));
        s1 = fmaf(v.z, v.z, fmaf(v.w, v.w, s1));
      }
    const float inv = 1.f / fmaxf(sqrtf(s0 + s1), 1e-12f);
    for (int rh = 0; rh < 2; ++rh) rf[c][rh] = __shfl_sync(FULL, inv, 16 * c + g + 8 * rh);
  }

  // pass 1: each lane's running max and sum of exp2 over its own keys
  float m[2][2], s[2][2], S[2][NJ][4];
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      m[br][rh] = -INFINITY;
      s[br][rh] = 0.f;
    }
  KeyMeta meta = key_meta(a, b, 0, min(KT, a.NK));
  issue_tile<T, DPAD>(ring, kp, vp, a, 0, min(KT, a.NK), false);
  for (int i = 0; i < nkt; ++i) {
    const int k0 = i * KT, kn = min(KT, a.NK - k0);
    const T* stage = ring + (i % STAGES) * 4 * TILE;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                  // tile i landed; tile i - 1's stage and factors free
    if (i + 1 < nkt)
      issue_tile<T, DPAD>(ring + ((i + 1) % STAGES) * 4 * TILE, kp, vp, a, k0 + KT,
                          min(KT, a.NK - k0 - KT), false);
    key_factors<T, DPAD>(kf, neg, stage, meta, kn, kscale);
    if (i + 1 < nkt) meta = key_meta(a, b, k0 + KT, min(KT, a.NK - k0 - KT));
    __syncthreads();
    tile_logits<T, DPAD, NJ>(S, sq, rows, stage, rg, j0, lane);
#pragma unroll
    for (int br = 0; br < 2; ++br)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float l[2 * NJ], mt = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int kk = col_key(j0 + jj, 2 * t);
          const float2 f = *reinterpret_cast<const float2*>(kf + br * KT + kk);
          const float2 ng = *reinterpret_cast<const float2*>(neg + kk);
          l[2 * jj] = fmaf(S[br][jj][2 * rh] * rf[br][rh], f.x, ng.x);
          l[2 * jj + 1] = fmaf(S[br][jj][2 * rh + 1] * rf[br][rh], f.y, ng.y);
          mt = fmaxf(mt, fmaxf(l[2 * jj], l[2 * jj + 1]));
        }
        const float mn = fmaxf(m[br][rh], mt), mu = mn == -INFINITY ? 0.f : mn;
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < 2 * NJ; ++e) ps += ex2(l[e] - mu);
        s[br][rh] = fmaf(s[br][rh], ex2(m[br][rh] - mu), ps);
        m[br][rh] = mn;
      }
  }

  // each row's max M and 0.5 / S: over the quad, then over the KW warps of
  // the row group in slice order
  float M[2][2], hs[2][2];
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = m[br][rh];
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      float sm = mx == -INFINITY ? 0.f : s[br][rh] * ex2(m[br][rh] - mx);
      sm += __shfl_xor_sync(FULL, sm, 1);
      sm += __shfl_xor_sync(FULL, sm, 2);
      M[br][rh] = mx;
      hs[br][rh] = sm;
      if (KW > 1 && t == 0) stats[(w * 2 + br) * 16 + g + 8 * rh] = make_float2(mx, sm);
    }
  __syncthreads();                    // pass 1's last stage read; the statistics written
  if (KW > 1) {
#pragma unroll
    for (int br = 0; br < 2; ++br)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float2* st = stats + (rg * KW * 2 + br) * 16 + g + 8 * rh;
        float mx = -INFINITY, sm = 0.f;
        for (int k = 0; k < KW; ++k) mx = fmaxf(mx, st[k * 32].x);
        for (int k = 0; k < KW; ++k)
          sm += st[k * 32].x == -INFINITY ? 0.f : st[k * 32].y * ex2(st[k * 32].x - mx);
        M[br][rh] = mx;
        hs[br][rh] = sm;
      }
  }
#pragma unroll
  for (int br = 0; br < 2; ++br)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) hs[br][rh] = 0.5f / hs[br][rh];

  // pass 2: attn written once, attn @ v_c and attn @ v_r accumulated
  float O[2][KS][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[c][n][e] = 0.f;
  const bool nk4 = a.NK % 4 == 0;
  meta = key_meta(a, b, 0, min(KT, a.NK));
  issue_tile<T, DPAD>(ring, kp, vp, a, 0, min(KT, a.NK), true);
  for (int i = 0; i < nkt; ++i) {
    const int k0 = i * KT, kn = min(KT, a.NK - k0);
    const T* stage = ring + (i % STAGES) * 4 * TILE;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < nkt)
      issue_tile<T, DPAD>(ring + ((i + 1) % STAGES) * 4 * TILE, kp, vp, a, k0 + KT,
                          min(KT, a.NK - k0 - KT), true);
    key_factors<T, DPAD>(kf, neg, stage, meta, kn, kscale);
    if (i + 1 < nkt) meta = key_meta(a, b, k0 + KT, min(KT, a.NK - k0 - KT));
    __syncthreads();
    tile_logits<T, DPAD, NJ>(S, sq, rows, stage, rg, j0, lane);
    // S[0] becomes attn: row g, key col_key(j0 + jj, 2t) + e in S[0][jj][e]; row g + 8 in [2 + e]
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int kk = col_key(j0 + jj, 2 * t);
      const float2 fc = *reinterpret_cast<const float2*>(kf + kk);
      const float2 fr = *reinterpret_cast<const float2*>(kf + KT + kk);
      const float2 ng = *reinterpret_cast<const float2*>(neg + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        const float lc = fmaf(S[0][jj][e] * rf[0][rh], e & 1 ? fc.y : fc.x, e & 1 ? ng.y : ng.x);
        const float lr = fmaf(S[1][jj][e] * rf[1][rh], e & 1 ? fr.y : fr.x, e & 1 ? ng.y : ng.x);
        S[0][jj][e] = fmaf(ex2(lc - M[0][rh]), hs[0][rh], ex2(lr - M[1][rh]) * hs[1][rh]);
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = 16 * rg + g + 8 * rh;
      if (row >= qn) continue;
      float* dst = a.attn + (row0 + row) * a.NK + k0;
      if constexpr (NJ > 1) {       // n-tiles j, j + 1: keys 16 (j / 2) + 4t .. + 3
#pragma unroll
        for (int jj = 0; jj < NJ; jj += 2) {
          const int kk = col_key(j0 + jj, 2 * t);
          const float4 v = make_float4(S[0][jj][2 * rh], S[0][jj][2 * rh + 1],
                                       S[0][jj + 1][2 * rh], S[0][jj + 1][2 * rh + 1]);
          if (nk4 && kk + 4 <= kn) {
            __stcs(reinterpret_cast<float4*>(dst + kk), v);
          } else {
            if (kk < kn) dst[kk] = v.x;
            if (kk + 1 < kn) dst[kk + 1] = v.y;
            if (kk + 2 < kn) dst[kk + 2] = v.z;
            if (kk + 3 < kn) dst[kk + 3] = v.w;
          }
        }
      } else {                      // one n-tile: keys col_key(j0, 2t), + 1
        const int kk = col_key(j0, 2 * t);
        if (a.NK % 2 == 0 && kk + 2 <= kn) {
          __stcs(reinterpret_cast<float2*>(dst + kk), make_float2(S[0][0][2 * rh], S[0][0][2 * rh + 1]));
        } else {
          if (kk < kn) dst[kk] = S[0][0][2 * rh];
          if (kk + 1 < kn) dst[kk + 1] = S[0][0][2 * rh + 1];
        }
      }
    }
    // attn @ v: k-step jj takes n-tile j0 + jj's keys, logical k = t the key
    // of column 2t (shared row 8 j + 2t), k = t + 4 that of column 2t + 1;
    // each (branch, dims) tile summed from zero, then added in fp32
    unsigned ph[NJ][4], pl[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      split<false>(S[0][jj][0], ph[jj][0], pl[jj][0]);
      split<false>(S[0][jj][2], ph[jj][1], pl[jj][1]);
      split<false>(S[0][jj][1], ph[jj][2], pl[jj][2]);
      split<false>(S[0][jj][3], ph[jj][3], pl[jj][3]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const T* vb = stage + (2 + c) * TILE + (8 * j0 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          unsigned bh[2], bl[2];
          split<EXACT>(ldf(vb + 8 * jj * LD + 8 * n), bh[0], bl[0]);
          split<EXACT>(ldf(vb + 8 * jj * LD + LD + 8 * n), bh[1], bl[1]);
          mma3<false, EXACT>(acc, ph[jj], pl[jj], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) O[c][n][e] += acc[e];
      }
    }
  }

  // out: each warp's sums into shared memory, then the row group's KW
  // slices added in slice order and written out, 4 dims a thread
  __syncthreads();                    // every warp done with the queries and the ring
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
#pragma unroll
      for (int n = 0; n < KS; ++n)
        *reinterpret_cast<float2*>(so + ((w * 2 + c) * 16 + g + 8 * rh) * LDO + 8 * n + 2 * t) =
            make_float2(O[c][n][2 * rh], O[c][n][2 * rh + 1]);
  __syncthreads();
  for (int i = tid; i < 2 * rows * (DPAD / 4); i += blockDim.x) {
    const int d = 4 * (i % (DPAD / 4)), r = (i / (DPAD / 4)) % rows, c = i / (DPAD / 4) / rows;
    if (r >= qn || d >= a.D) continue;
    const float* src = so + (((r / 16) * KW * 2 + c) * 16 + r % 16) * LDO + d;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int k = 1; k < KW; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(src + k * 2 * 16 * LDO);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    float* dst = a.out[c] + (row0 + r) * a.D + d;
    if (a.D % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      dst[0] = acc.x;
      if (d + 1 < a.D) dst[1] = acc.y;
      if (d + 2 < a.D) dst[2] = acc.z;
      if (d + 3 < a.D) dst[3] = acc.w;
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The shared memory of a streaming instance's largest block: 128 / KW rows
// (32 at KW 4), at most stream_max_rows(DPAD).
template <typename T, int DPAD, int KW>
cudaError_t allow_stream() {
  const int rows = std::min(stream_max_rows(DPAD), KW == 4 ? 32 : MAX_ROWS / KW);
  return allow_smem(fused_dual_attention_stream<T, DPAD, KW>, stream_smem<T>(DPAD, rows, KW));
}

// Every kernel's shared-memory limit, raised once a device and kept, and
// the device's SM count (the streaming route's tile rule reads it).
cudaError_t configure(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  static int sm_count[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    const size_t split = split_smem(DMAX, shared_stride(DMAX));
    cudaError_t e[17] = {
        allow_smem(fused_dual_attention_split<float>, split),
        allow_smem(fused_dual_attention_split<__nv_bfloat16>, split),
        allow_stream<float, 32, 1>(), allow_stream<float, 32, 2>(), allow_stream<float, 32, 4>(),
        allow_stream<float, 64, 1>(), allow_stream<float, 64, 2>(), allow_stream<float, 64, 4>(),
        allow_stream<float, 128, 4>(),
        allow_stream<__nv_bfloat16, 32, 1>(), allow_stream<__nv_bfloat16, 32, 2>(),
        allow_stream<__nv_bfloat16, 32, 4>(), allow_stream<__nv_bfloat16, 64, 1>(),
        allow_stream<__nv_bfloat16, 64, 2>(), allow_stream<__nv_bfloat16, 64, 4>(),
        allow_stream<__nv_bfloat16, 128, 4>(),
        cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev)};
    status[dev] = cudaSuccess;
    for (cudaError_t x : e)
      if (status[dev] == cudaSuccess) status[dev] = x;
  });
  if (sms) *sms = sm_count[dev];
  return status[dev];
}

size_t scratch_bytes(int B, int H, int NQ, int NK, int D) {
  const size_t rows = static_cast<size_t>(B) * H * NQ;
  const size_t nch = (NK + KC - 1) / KC, DP = (D + 3) / 4 * 4;
  return sizeof(float) * rows * (nch * 4 + nch * NPROD * DP + 2 * static_cast<size_t>(NK));
}

// The arguments both routes share: q/k/v and their strides (batch, head,
// row of qc, kc, vc, qr, kr, vr in elements), the score, the mask and the
// outputs; `vec` where every q/k/v row starts on a group of 4 values.
bool make_args(Args& a, const void* const qkv[6], const long long* strides,
               const void* score, const void* valid, void* out_c, void* out_r, void* attn,
               int B, int H, int NQ, int NK, int D, float scale, int bf16) {
  if (D < 1 || D > DMAX || B < 1 || H < 1 || NQ < 1 || NK < 1 ||
      static_cast<long long>(B) * H > 65535)
    return false;
  a.H = H; a.NQ = NQ; a.NK = NK; a.D = D;
  a.DP = (D + 3) / 4 * 4;
  a.DS = shared_stride(a.DP);
  a.nch = (NK + KC - 1) / KC;
  a.scale = scale;
  for (int br = 0; br < 2; ++br) {
    a.q[br] = qkv[3 * br];
    a.k[br] = qkv[3 * br + 1];
    a.v[br] = qkv[3 * br + 2];
    for (int s = 0; s < 3; ++s) {
      a.qs[br][s] = strides[(3 * br) * 3 + s];
      a.ks[br][s] = strides[(3 * br + 1) * 3 + s];
      a.vs[br][s] = strides[(3 * br + 2) * 3 + s];
    }
  }
  a.score = static_cast<const float*>(score);
  a.fg = nullptr;
  a.valid = static_cast<const unsigned char*>(valid);
  a.out[0] = static_cast<float*>(out_c);
  a.out[1] = static_cast<float*>(out_r);
  a.attn = static_cast<float*>(attn);
  const size_t group = bf16 ? 8 : 16;      // bytes of 4 values
  a.vec = D % 4 == 0;
  for (int i = 0; i < 6; ++i) {
    a.vec = a.vec && reinterpret_cast<size_t>(qkv[i]) % group == 0;
    for (int s = 0; s < 3; ++s) a.vec = a.vec && strides[3 * i + s] % 4 == 0;
  }
  return true;
}

// A streaming launch's shape: the instance (DPAD, KW), its block and grid.
struct StreamShape {
  int dpad;
  StreamPlan plan;
  dim3 grid, block;
  size_t smem;
};

StreamShape stream_shape(int B, int H, int NQ, int D, bool bf16, int sms) {
  StreamShape s;
  const int dp = (D + 3) / 4 * 4;
  s.dpad = dp <= 32 ? 32 : dp <= 64 ? 64 : 128;
  s.plan = stream_plan(B, H, NQ, s.dpad, sms);
  s.grid = dim3((NQ + s.plan.rows - 1) / s.plan.rows, static_cast<unsigned>(B * H));
  s.block = dim3(32 * s.plan.rows / 16 * s.plan.kw);
  s.smem = bf16 ? stream_smem<__nv_bfloat16>(s.dpad, s.plan.rows, s.plan.kw)
                : stream_smem<float>(s.dpad, s.plan.rows, s.plan.kw);
  return s;
}

template <typename T, int DPAD>
const void* stream_kernel_kw(int kw) {
  if (DPAD == 128 || kw == 4)
    return reinterpret_cast<const void*>(fused_dual_attention_stream<T, DPAD, 4>);
  if (kw == 2) return reinterpret_cast<const void*>(fused_dual_attention_stream<T, DPAD, 2>);
  return reinterpret_cast<const void*>(fused_dual_attention_stream<T, DPAD, 1>);
}

// the instance a shape launches (DPAD 128 has only KW 4: 32 rows at most)
template <typename T>
const void* stream_kernel(const StreamShape& s) {
  if (s.dpad == 32) return stream_kernel_kw<T, 32>(s.plan.kw);
  if (s.dpad == 64) return stream_kernel_kw<T, 64>(s.plan.kw);
  return reinterpret_cast<const void*>(fused_dual_attention_stream<T, 128, 4>);
}

template <typename T>
cudaError_t launch_stream(Args& a, const StreamShape& s, cudaStream_t st) {
  void* args[] = {&a};
  return cudaLaunchKernel(stream_kernel<T>(s), s.grid, s.block, args, s.smem, st);
}

}  // namespace

// The split route. strides: (batch, head, row) of qc, kc, vc, qr, kr, vr
// in elements; fg: the reg branch's per-key score (B, NK) fp32, or null
// for none; scratch: at least scratch_bytes(...) bytes, 16-byte aligned;
// bf16: q, k and v are bf16 (else fp32).
extern "C" int tscd_fused_dual_attention(
    const void* qc, const void* kc, const void* vc, const void* qr,
    const void* kr, const void* vr, const void* score, const void* fg, const void* valid,
    void* out_c, void* out_r, void* attn, void* scratch, size_t scratch_size,
    const long long* strides, int B, int H, int NQ, int NK, int D,
    float scale, int bf16, void* stream) {
  const void* qkv[6] = {qc, kc, vc, qr, kr, vr};
  Args a;
  if (!make_args(a, qkv, strides, score, valid, out_c, out_r, attn, B, H, NQ, NK, D, scale,
                 bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nqt = (NQ + QT - 1) / QT;
  const size_t combine_smem =
      sizeof(float) * (2 * static_cast<size_t>(a.nch) + (CTHREADS / (2 * D)) * 2 * D);
  if (nqt > 65535 || combine_smem > COMBINE_SMEM_MAX ||
      scratch_size < scratch_bytes(B, H, NQ, NK, D) ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.fg = static_cast<const float*>(fg);
  const size_t rows = static_cast<size_t>(B) * H * NQ;
  a.stats = static_cast<float4*>(scratch);
  a.part = reinterpret_cast<float*>(a.stats + rows * a.nch);
  a.p[0] = a.part + rows * a.nch * NPROD * a.DP;
  a.p[1] = a.p[0] + rows * NK;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.nch, static_cast<unsigned>(B * H), nqt);
  if (bf16)
    fused_dual_attention_split<__nv_bfloat16><<<grid, THREADS, split_smem(a.DP, a.DS), st>>>(a);
  else
    fused_dual_attention_split<float><<<grid, THREADS, split_smem(a.DP, a.DS), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_dual_attention_combine<<<dim3(NQ, static_cast<unsigned>(B * H)), CTHREADS,
                                 combine_smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The streaming route, arguments as the split route's, with no scratch.
extern "C" int tscd_fused_dual_attention_stream(
    const void* qc, const void* kc, const void* vc, const void* qr,
    const void* kr, const void* vr, const void* score, const void* fg, const void* valid,
    void* out_c, void* out_r, void* attn, const long long* strides,
    int B, int H, int NQ, int NK, int D, float scale, int bf16, void* stream) {
  const void* qkv[6] = {qc, kc, vc, qr, kr, vr};
  Args a;
  if (!make_args(a, qkv, strides, score, valid, out_c, out_r, attn, B, H, NQ, NK, D, scale,
                 bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.fg = static_cast<const float*>(fg);
  const StreamShape s = stream_shape(B, H, NQ, D, bf16, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_stream<__nv_bfloat16>(a, s, st) : launch_stream<float>(a, s, st);
  const cudaError_t last = cudaGetLastError();     // read, so that no later check sees it
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The streaming launch at (B, H, NQ, D) as the entry point above makes it,
// for checks: out = {query rows a block, threads a block, blocks (grid x),
// dynamic shared memory, blocks a SM, registers a thread, local (spill)
// bytes a thread, key slices (KW)}.
extern "C" int tscd_fused_dual_attention_stream_config(int B, int H, int NQ, int D, int bf16,
                                                       int* out) {
  if (D < 1 || D > DMAX || B < 1 || H < 1 || NQ < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StreamShape s = stream_shape(B, H, NQ, D, bf16, sms);
  const void* kernel = bf16 ? stream_kernel<__nv_bfloat16>(s) : stream_kernel<float>(s);
  int per_sm = 0;
  cudaFuncAttributes attr;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.block.x, s.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = s.plan.rows;
  out[1] = static_cast<int>(s.block.x);
  out[2] = static_cast<int>(s.grid.x);
  out[3] = static_cast<int>(s.smem);
  out[4] = per_sm;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  out[7] = s.plan.kw;
  return 0;
}
