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
// fp32 FMA throughout, accurate expf. TF32, the tensor cores' only route
// for fp32 inputs, keeps about 3 decimal digits: at a logit scale of 25
// that moves the probabilities by about 1% relative, against the 1e-5
// the port is checked to, and the matcher after it is sensitive to the
// last digit. The whole product work takes 2.45 us on the CUDA cores.
//
// Resources (nvcc -Xptxas -v, build/kernels/build.log): split 127
// registers, combine 32, no spills; dynamic shared memory 85 KiB a split
// block at D = 64 (149 KiB at D = 128), 4.4 KiB a combine block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
// scratch would grow as NQ x NK x D. One block owns a (batch, head, tile
// of SQT query rows) and streams the keys through shared memory twice:
//   pass 1  per key tile of SKT keys, both branches' logits of the tile,
//           then the online softmax's running max and sum of each row and
//           branch (kept in registers, the same in the 16 lanes of a row);
//   pass 2  the logits again; with the final statistics p = exp(l - M) / S
//           of both branches into shared memory, attn = (p_c + p_r) / 2
//           written once to device memory, and attn @ v_c, attn @ v_r
//           accumulated in registers over the tiles.
// The rows' (M, S) of both branches stay in registers from pass 1 into
// pass 2: the route needs no scratch.
// Each half of the block takes one branch in the logits (a thread 4 rows x
// 4 keys; q and k dim-major in shared memory, so a dim is one float4 of
// each) and in the products (a thread NG/4 rows x 4 dims of its branch's
// values). fp32 FMA throughout, accurate expf, no atomics, every sum in a
// fixed order: deterministic. Pass 2's recompute of the logits makes its
// work 12 q k d flops a head against the 8 the function needs.
// Bound on an H100 at OVIS YOLOV++'s q = k = 16000, h 4, d 64: 5.24e11
// flops (7.8 ms at 67 TFLOP/s fp32) against 4.1 GB of attn written (1.22
// ms at 3.35 TB/s), so operations bound it; the design's own floor is 1.5x
// that (11.7 ms). Shared memory 71.5 KiB a block at D <= 64 (45.5 KiB at
// D <= 32, 123.5 KiB past 64); a grid of ceil(NQ / 32) x B H blocks (120 at YOLOV-L's
// q = 960, 2000 at 16000).
constexpr int SQT = 32;                 // query rows of a streaming block
constexpr int SKT = 64;                 // keys of a tile
constexpr int STHREADS = 256;           // streaming block: a half a branch
constexpr int SHALF = STHREADS / 2;
constexpr int SQLD = SQT + 4;           // row stride of the dim-major q tile
constexpr int SKLD = SKT + 4;           // row stride of the dim-major k tile
constexpr int SALD = SQT + 4;           // row stride of the key-major probabilities

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
__device__ __forceinline__ float get1(const float* p) { return *p; }
__device__ __forceinline__ float get1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// values t .. t + 3 of row r (row stride rs), zeros past n rows or D columns;
// with vec (D and the strides multiples of 4, aligned) one 4-value load
template <typename T>
__device__ __forceinline__ float4 row4(const T* src, long long rs, int r, int t, int n,
                                       int D, bool vec) {
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= n || t >= D) return o;
  const T* p = src + r * rs + t;
  if (vec) return get4(p);
  o.x = get1(p);
  if (t + 1 < D) o.y = get1(p + 1);
  if (t + 2 < D) o.z = get1(p + 2);
  if (t + 3 < D) o.w = get1(p + 3);
  return o;
}

// rows x DPAD values of src, transposed: dst[d * ld + r] (rows fastest, so
// the stores of a warp fall on distinct banks)
template <typename T, int DPAD>
__device__ __forceinline__ void load_cols(float* dst, int ld, const T* src, long long rs,
                                          int rows, int n, int D, bool vec) {
  for (int i = threadIdx.x; i < rows * (DPAD / 4); i += STHREADS) {
    const int r = i % rows, t = (i / rows) * 4;
    const float4 v = row4(src, rs, r, t, n, D, vec);
    dst[t * ld + r] = v.x;
    dst[(t + 1) * ld + r] = v.y;
    dst[(t + 2) * ld + r] = v.z;
    dst[(t + 3) * ld + r] = v.w;
  }
}

// rows x DPAD values of src as they are: dst[r * DPAD + d]
template <typename T, int DPAD>
__device__ __forceinline__ void load_rows_as_is(float* dst, const T* src, long long rs,
                                                int rows, int n, int D, bool vec) {
  constexpr int G = DPAD / 4;
  for (int i = threadIdx.x; i < rows * G; i += STHREADS) {
    const int r = i / G, t = (i - r * G) * 4;
    *reinterpret_cast<float4*>(dst + r * DPAD + t) = row4(src, rs, r, t, n, D, vec);
  }
}

// 1 / max(|x|, 1e-12) of the vector x[0], x[ld], ..., x[(DPAD - 1) ld]
template <int DPAD>
__device__ __forceinline__ float inv_norm_col(const float* x, int ld) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (int d = 0; d < DPAD; d += 4) {
    s0 = fmaf(x[d * ld], x[d * ld], s0);
    s1 = fmaf(x[(d + 1) * ld], x[(d + 1) * ld], s1);
    s2 = fmaf(x[(d + 2) * ld], x[(d + 2) * ld], s2);
    s3 = fmaf(x[(d + 3) * ld], x[(d + 3) * ld], s3);
  }
  return 1.f / fmaxf(sqrtf((s0 + s1) + (s2 + s3)), 1e-12f);
}

struct StreamSmem {
  float* sq;        // [2][DPAD][SQLD] queries of both branches, dim-major
  float* skv;       // [2][DPAD][SKLD] keys, dim-major; or [2][SKT][DPAD] values
  float* sa;        // [2][SKT][SALD] p of both branches, key-major; [0] then attn
  float* inv_q;     // [2][SQT]
  float* inv_k;     // [2][SKT]
  float* score;     // [SKT] cls score of each key
  float* fg;        // [SKT] reg score of each key (1 without one)
  float* neg;       // [SKT] 0 or -1e9
};

size_t stream_smem(int DPAD) {
  return sizeof(float) * (2 * DPAD * SQLD + 2 * DPAD * SKLD + 2 * SKT * SALD + 2 * SQT +
                          2 * SKT + 3 * SKT);
}

// the key tile k0 .. k0 + kn of both branches (dim-major), its inverse
// norms and each key's scores and mask; ends synced
template <typename T, int DPAD>
__device__ __forceinline__ void stream_keys(const Args& a, const StreamSmem& s, int b, int h,
                                            int k0, int kn) {
  for (int c = 0; c < 2; ++c) {
    const T* k = static_cast<const T*>(a.k[c]);
    load_cols<T, DPAD>(s.skv + c * DPAD * SKLD, SKLD,
                       k + b * a.ks[c][0] + h * a.ks[c][1] + k0 * a.ks[c][2], a.ks[c][2],
                       SKT, kn, a.D, a.vec);
  }
  const int t = threadIdx.x;
  if (t < SKT) {
    const bool in = t < kn;
    const size_t key = static_cast<size_t>(b) * a.NK + k0 + t;
    s.score[t] = in ? a.score[key] : 0.f;
    s.fg[t] = in && a.fg ? a.fg[key] : 1.f;
    s.neg[t] = in && a.valid[key] ? 0.f : NEG;
  }
  __syncthreads();
  if (t < 2 * SKT)
    s.inv_k[t] = inv_norm_col<DPAD>(s.skv + (t / SKT) * DPAD * SKLD + t % SKT, SKLD);
  __syncthreads();
}

// the scaled, score-weighted and masked logits of branch br at rows
// 4 ty + i and keys 4 tx + j of the tile; keys past kn are -inf (p = 0)
template <int DPAD>
__device__ __forceinline__ void stream_logits(float l[4][4], const Args& a, const StreamSmem& s,
                                              int br, int tx, int ty, int kn) {
  const float* qb = s.sq + br * DPAD * SQLD + 4 * ty;
  const float* kb = s.skv + br * DPAD * SKLD + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) l[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DPAD; ++d) {
    const float4 qv = ld4(qb + d * SQLD), kv = ld4(kb + d * SKLD);
    const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) l[i][j] = fmaf(qa[i], ka[j], l[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = 4 * tx + j;
    const float sc = br == 0 ? s.score[kk] : s.fg[kk];
    const float ik = s.inv_k[br * SKT + kk], ng = s.neg[kk];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = l[i][j] * s.inv_q[br * SQT + 4 * ty + i] * ik * a.scale * sc;
      l[i][j] = kk < kn ? x + ng : -INFINITY;
    }
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(STHREADS, 2)
fused_dual_attention_stream(const Args a) {
  extern __shared__ __align__(16) float smem[];
  StreamSmem s;
  s.sq = smem;
  s.skv = s.sq + 2 * DPAD * SQLD;
  s.sa = s.skv + 2 * DPAD * SKLD;
  s.inv_q = s.sa + 2 * SKT * SALD;
  s.inv_k = s.inv_q + 2 * SQT;
  s.score = s.inv_k + 2 * SKT;
  s.fg = s.score + SKT;
  s.neg = s.fg + SKT;

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * SQT, qn = min(SQT, a.NQ - q0);
  const int tid = threadIdx.x, br = tid / SHALF, t2 = tid - br * SHALF;
  const int tx = t2 & 15, ty = t2 >> 4;
  const size_t row0 = static_cast<size_t>(bh) * a.NQ + q0;

  for (int c = 0; c < 2; ++c) {
    const T* q = static_cast<const T*>(a.q[c]);
    load_cols<T, DPAD>(s.sq + c * DPAD * SQLD, SQLD,
                       q + b * a.qs[c][0] + h * a.qs[c][1] + q0 * a.qs[c][2], a.qs[c][2],
                       SQT, qn, a.D, a.vec);
  }
  __syncthreads();
  if (tid < 2 * SQT)
    s.inv_q[tid] = inv_norm_col<DPAD>(s.sq + (tid / SQT) * DPAD * SQLD + tid % SQT, SQLD);

  // pass 1: the online softmax's max and sum of each of the thread's rows
  float m[4], sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    sum[i] = 0.f;
  }
  for (int k0 = 0; k0 < a.NK; k0 += SKT) {
    const int kn = min(SKT, a.NK - k0);
    __syncthreads();
    stream_keys<T, DPAD>(a, s, b, h, k0, kn);
    float l[4][4];
    stream_logits<DPAD>(l, a, s, br, tx, ty, kn);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(l[i][0], l[i][1]), fmaxf(l[i][2], l[i][3]));
      for (int o = 1; o < 16; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float mn = fmaxf(m[i], mt);
      float ps = ((expf(l[i][0] - mn) + expf(l[i][1] - mn)) + expf(l[i][2] - mn)) +
                 expf(l[i][3] - mn);
      for (int o = 1; o < 16; o <<= 1) ps += __shfl_xor_sync(FULL, ps, o);
      sum[i] = fmaf(sum[i], expf(m[i] - mn), ps);
      m[i] = mn;
    }
  }
  float inv_s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv_s[i] = 1.f / sum[i];

  // pass 2: attn written once, attn @ v of the thread's branch accumulated
  constexpr int NG = DPAD / 4, RPN = NG / 4;     // a thread RPN rows x 4 dims
  const int px = t2 % NG, py = t2 / NG;
  float4 acc[RPN];
#pragma unroll
  for (int i = 0; i < RPN; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* sa_own = s.sa + br * SKT * SALD;
  const float* sv = s.skv + br * SKT * DPAD;
  for (int k0 = 0; k0 < a.NK; k0 += SKT) {
    const int kn = min(SKT, a.NK - k0);
    __syncthreads();
    stream_keys<T, DPAD>(a, s, b, h, k0, kn);
    float l[4][4];
    stream_logits<DPAD>(l, a, s, br, tx, ty, kn);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sa_own + (4 * tx + j) * SALD + 4 * ty) =
          make_float4(expf(l[0][j] - m[0]) * inv_s[0], expf(l[1][j] - m[1]) * inv_s[1],
                      expf(l[2][j] - m[2]) * inv_s[2], expf(l[3][j] - m[3]) * inv_s[3]);
    __syncthreads();
    for (int c = 0; c < 2; ++c) {
      const T* v = static_cast<const T*>(a.v[c]);
      load_rows_as_is<T, DPAD>(s.skv + c * SKT * DPAD,
                               v + b * a.vs[c][0] + h * a.vs[c][1] + k0 * a.vs[c][2],
                               a.vs[c][2], SKT, kn, a.D, a.vec);
    }
    for (int e = tid; e < SQT * SKT; e += STHREADS) {
      const int key = e % SKT, row = e / SKT;
      const float x = 0.5f * (s.sa[key * SALD + row] + s.sa[(SKT + key) * SALD + row]);
      s.sa[key * SALD + row] = x;
      if (row < qn && key < kn) a.attn[(row0 + row) * a.NK + k0 + key] = x;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 v = ld4(sv + kk * DPAD + 4 * px);
      const float* ap = s.sa + kk * SALD + RPN * py;
      if constexpr (RPN % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RPN; i += 4) {
          const float4 x = ld4(ap + i);
          axpy4(acc[i], x.x, v);
          axpy4(acc[i + 1], x.y, v);
          axpy4(acc[i + 2], x.z, v);
          axpy4(acc[i + 3], x.w, v);
        }
      } else {
        const float2 x = *reinterpret_cast<const float2*>(ap);
        axpy4(acc[0], x.x, v);
        axpy4(acc[1], x.y, v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPN; ++i) {
    const int row = RPN * py + i;
    if (row >= qn) continue;
    float* dst = a.out[br] + (row0 + row) * a.D + 4 * px;
    const float o[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * px + c < a.D) dst[c] = o[c];
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Every kernel's shared-memory limit, raised once a device and kept.
cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    const size_t split = split_smem(DMAX, shared_stride(DMAX));
    cudaError_t e[8] = {
        allow_smem(fused_dual_attention_split<float>, split),
        allow_smem(fused_dual_attention_split<__nv_bfloat16>, split),
        allow_smem(fused_dual_attention_stream<float, 32>, stream_smem(32)),
        allow_smem(fused_dual_attention_stream<float, 64>, stream_smem(64)),
        allow_smem(fused_dual_attention_stream<float, 128>, stream_smem(128)),
        allow_smem(fused_dual_attention_stream<__nv_bfloat16, 32>, stream_smem(32)),
        allow_smem(fused_dual_attention_stream<__nv_bfloat16, 64>, stream_smem(64)),
        allow_smem(fused_dual_attention_stream<__nv_bfloat16, 128>, stream_smem(128))};
    status[dev] = cudaSuccess;
    for (cudaError_t x : e)
      if (status[dev] == cudaSuccess) status[dev] = x;
  });
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

template <typename T>
void launch_stream(const Args& a, dim3 grid, cudaStream_t st) {
  const int DPAD = a.DP <= 32 ? 32 : a.DP <= 64 ? 64 : 128;
  if (DPAD == 32)
    fused_dual_attention_stream<T, 32><<<grid, STHREADS, stream_smem(32), st>>>(a);
  else if (DPAD == 64)
    fused_dual_attention_stream<T, 64><<<grid, STHREADS, stream_smem(64), st>>>(a);
  else
    fused_dual_attention_stream<T, 128><<<grid, STHREADS, stream_smem(128), st>>>(a);
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
  cudaError_t err = configure();
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
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.fg = static_cast<const float*>(fg);
  const dim3 grid((NQ + SQT - 1) / SQT, static_cast<unsigned>(B * H));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_stream<__nv_bfloat16>(a, grid, st);
  else
    launch_stream<float>(a, grid, st);
  return static_cast<int>(cudaGetLastError());
}
