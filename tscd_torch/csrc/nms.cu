// Greedy NMS over boxes in score order: which boxes survive, given the
// boxes themselves.
//
// Replaces no Pallas kernel. It replaces the IoU matrix and the XLA
// `lax.scan` of tscd_tpu/ops/nms.py:43-53 (nms_fixed): the (K, K) overlap
// matrix `pairwise_iou_xyxy(boxes_s, boxes_s) > iou_threshold`, then K
// dependent steps, each deciding one box. PyTorch has no device loop, so
// the port's plain version builds that matrix in torch and iterates a
// fixed point with host reads; these two kernels take the boxes, never
// write the matrix, and let the postprocess enqueue without waiting.
//
// Inputs (contiguous): boxes (B, K, 4) fp32 xyxy and valid (B, K) bool (one
// byte), both in score order, and the threshold. Output keep (B, K) bool:
//   keep[i] = valid[i] & !any_{j < i} (IoU(i, j) > thr & keep[j]).
// Scratch: the bit matrix as tiles (B, NT, 32) uint32, nb = ceil(K / 32)
// row blocks, NT = nb (nb + 1) / 2, tile t = c (c + 1) / 2 + w (w <= c), so
// that row block c's tiles are contiguous: below the diagonal (w < c) word
// r holds row i = 32 c + r, bit l set when box j = 32 w + l overlaps box i
// above the threshold; the diagonal tile (c, c) holds the same decisions
// transposed, word l the later rows 32 c + r (r > l) that box 32 c + l
// overlaps. Rows and columns past K are 0. Then each row block's invalid
// rows, (B, nb) words.
//
// Bound: latency. Bytes: K boxes and valid flags in, K flags out (27 KB
// at the main path's K = 1500, 0.008 us at 3.35 TB/s); the bit matrix is
// this code's own intermediate. Operations: K (K - 1) / 2 IoUs of 14 fp32
// operations, 0.23 us at 67 TFLOP/s. The K decisions form one dependent
// chain of at least one integer operation each: about 3 us at K = 1500.
//
// Design: two launches.
// 1. nms_pack_iou, over the whole card: one warp a quarter tile (8 rows),
//    so every task is the same 8 x 32 IoUs and 4 warps share a tile. Lane
//    l holds column box j = 32 w + l; the rows' boxes sit in shared memory
//    and are read as broadcasts; each row's 32 decisions become one word
//    by __ballot_sync, and lane r keeps row r's word. The division runs
//    only when a lane of the warp has a nonzero intersection (an empty one
//    gives IoU 0 exactly). The warp of each diagonal tile's first quarter
//    also ballots the row block's valid flags.
// 2. nms_walk_rows, one warp a frame, settles 32 boxes (a row block) a
//    step. Bulk copies (the Tensor Memory Accelerator, one instruction for
//    up to 8 row blocks' tiles) keep two batches of rows in shared memory,
//    each completing on an mbarrier. For row block c, lane r ORs its row's
//    words of the earlier blocks AND their settled keep words (8 blocks a
//    step, 4-word loads of the keep words), and a ballot of that gives the
//    rows some kept box overlaps: the block's `alive` word. Its own
//    triangle, held as columns col[l] (the rows box l suppresses), settles
//    it by a chain of register operations, alive &= ~(col[l] & -(alive
//    >> l & 1)): no vote, shared-memory load or barrier on the chain, and
//    no chain at all when no alive box suppresses another.
//
// Every IoU operation is IEEE and rounded to nearest one at a time
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), in the order of
// ops/boxes.py:pairwise_iou_xyxy: nvcc would otherwise contract a * b + c
// into an FMA (-fmad=true is its default), and the threshold's decisions
// must be the torch IoU's bit for bit, also at the class shift's large
// coordinates, where every subtraction's rounding matters. fmaxf/fminf
// stand for torch.maximum/minimum and clamp(min=0); they differ only on
// NaN, and the boxes are finite. The threshold and eps = 1e-16 are fp32,
// as torch casts a Python scalar; the compare is `>`. Do not build this
// file with --use_fast_math.
//
// Resources: K <= 16384 (nb <= 512: OVIS YOLOV++'s refined postprocess
// takes K = 500 proposals x 25 classes = 12500); the walk's shared memory
// is two slots of up to 8 rows (fewer past nb = 100, one past nb = 400;
// at most 205 KB): 98.5 KB at K = 1500, 200.4 KB at K = 12500. No atomics: the same result every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KMAX = 16384;
constexpr int PACK_WARPS = 8;
constexpr int PACK_ROWS = 8;                // rows of a tile a warp packs: 4 warps a tile
constexpr int BATCH_ROWS = 8;               // row blocks a bulk copy brings, at most
constexpr int RING_BYTES = 200 * 1024;      // the walk's two batch slots, at most
constexpr float EPS = 1e-16f;               // ops/boxes.py:pairwise_iou_xyxy's eps
constexpr int MAX_DEVICES = 64;

__host__ __device__ constexpr int row_blocks(int K) { return (K + 31) / 32; }
__host__ __device__ constexpr int tiles_of(int nb) { return nb * (nb + 1) / 2; }

// Row blocks a batch holds: two batches of BATCH_ROWS full rows fit in
// RING_BYTES up to nb = 100; past it, fewer
__host__ __device__ constexpr int batch_rows(int nb) {
  return RING_BYTES / (2 * nb * 128) < BATCH_ROWS ? RING_BYTES / (2 * nb * 128) : BATCH_ROWS;
}
// a slot: a batch's rows (at most batch_rows full rows of nb tiles) and
// seven tiles past them, which the fold reads and multiplies by zero
// keep words
__host__ __device__ constexpr int slot_words(int nb) { return (batch_rows(nb) * nb + 7) * 32; }
// the slots, 2 mbarriers, keep [nb + 8] (16-byte aligned), dead [nb]
__host__ __device__ constexpr int walk_smem_words(int nb) {
  return 2 * slot_words(nb) + 4 + (nb + 8) + nb;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One bulk copy (the Tensor Memory Accelerator) of `bytes` from global to
// shared memory, completing on `bar`, which expects that many bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_done(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of `bar` with this parity to complete; traps rather
// than hang if it never does.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  if (mbar_done(bar, parity)) return;
  for (long long n = 0; !mbar_done(bar, parity); ++n)
    if (n > (1ll << 26)) __trap();
}

// (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// pairwise_iou_xyxy(a, b) > thr for one pair, operation by operation:
// wh = (min(a2, b2) - max(a1, b1)).clamp(min=0), inter = w * h,
// union = (area_a + area_b) - inter, iou = inter / (union + eps).
// Called by the whole warp.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // inter = 0 gives iou = 0 exactly (union + eps > 0): the division runs
  // only where a lane of the warp needs it, and never divides 0, which
  // would take its slow path
  const bool meet = inter != 0.f;
  float iou = 0.f;
  if (__any_sync(FULL, meet)) {
    const float q = __fdiv_rn(meet ? inter : 1.f, __fadd_rn(uni, EPS));
    iou = meet ? q : 0.f;
  }
  return iou > thr;
}

__global__ void __launch_bounds__(32 * PACK_WARPS)
nms_pack_iou(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
             unsigned* __restrict__ tiles, unsigned* __restrict__ dead, int K, float thr) {
  constexpr int PARTS = 32 / PACK_ROWS;
  __shared__ float4 s_box[PACK_WARPS][PACK_ROWS];
  __shared__ float s_area[PACK_WARPS][PACK_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = tiles_of(row_blocks(K));
  const int task = blockIdx.x * PACK_WARPS + warp;
  const int t = task / PARTS, r0 = task % PARTS * PACK_ROWS;
  if (t >= nt) return;
  // t = c (c + 1) / 2 + w, w <= c
  int c = static_cast<int>((sqrtf(8.f * static_cast<float>(t) + 1.f) - 1.f) * 0.5f);
  while (c * (c + 1) / 2 > t) --c;
  while ((c + 1) * (c + 2) / 2 <= t) ++c;
  const int w = t - c * (c + 1) / 2;
  const float4* fb = boxes + static_cast<size_t>(blockIdx.y) * K;
  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i0 = 32 * c + r0, j = 32 * w + lane;
  const float4 bj = j < K ? fb[j] : none;
  const float aj = box_area(bj);
  if (lane < PACK_ROWS) {
    const float4 bi = i0 + lane < K ? fb[i0 + lane] : none;
    s_box[warp][lane] = bi;
    s_area[warp][lane] = box_area(bi);
  }
  __syncwarp();
  // a tile below the diagonal keeps row i's word over its columns j < i;
  // the diagonal tile keeps box i's column over the later rows j > i of
  // its block, the same decisions transposed (the IoU is symmetric bit
  // for bit: every operation on the pair commutes)
  const bool diag = w == c;
  if (diag && r0 == 0) {                               // one warp a row block: its invalid rows
    const int i = 32 * c + lane;
    const unsigned d = __ballot_sync(FULL, i >= K || valid[static_cast<size_t>(blockIdx.y) * K + i] == 0);
    if (lane == 0) dead[static_cast<size_t>(blockIdx.y) * row_blocks(K) + c] = d;
  }
  unsigned mine = 0u;
#pragma unroll
  for (int r = 0; r < PACK_ROWS; ++r) {
    const int i = i0 + r;
    const bool o = overlaps(s_box[warp][r], s_area[warp][r], bj, aj, thr);
    const unsigned word = __ballot_sync(FULL, o && (diag ? i < j && j < K : i < K));
    if (lane == r0 + r) mine = word;
  }
  if (lane >= r0 && lane < r0 + PACK_ROWS)
    tiles[(static_cast<size_t>(blockIdx.y) * nt + t) * 32 + lane] = mine;
}

// One warp a frame. Row block c's tiles (c, 0 .. c) are contiguous; bulk
// copies bring them in batches of batch_rows(nb) rows, two batches in
// flight.
__global__ void __launch_bounds__(32)
nms_walk_rows(const unsigned* __restrict__ tiles, const unsigned* __restrict__ dead,
              uint8_t* __restrict__ keep_out, int K) {
  extern __shared__ __align__(16) unsigned smem[];
  const int nb = row_blocks(K), rows = batch_rows(nb), lane = threadIdx.x;
  unsigned* const ring = smem;                               // batch i in slot i & 1
  unsigned long long* const bars =                           // [i & 1]: batch i landed
      reinterpret_cast<unsigned long long*>(ring + 2 * slot_words(nb));
  unsigned* const s_keep = reinterpret_cast<unsigned*>(bars + 2);  // [c]: settled keep words
  unsigned* const s_dead = s_keep + nb + 8;                  // [c]: invalid rows
  const unsigned* const src = tiles + static_cast<size_t>(blockIdx.x) * tiles_of(nb) * 32;
  const int batches = (nb + rows - 1) / rows;

  // lane 0: start copying batch i (row blocks i * rows on) into its slot
  auto stage = [&](int i) {
    if (lane == 0 && i < batches) {
      const int c0 = i * rows, c1 = min(c0 + rows, nb);
      bulk_copy(ring + (i & 1) * slot_words(nb), src + 32 * tiles_of(c0),
                (tiles_of(c1) - tiles_of(c0)) * 128, bars + (i & 1));
    }
  };

  for (int k = lane; k < nb + 8; k += 32) s_keep[k] = 0u;
  for (int k = lane; k < nb; k += 32) s_dead[k] = dead[static_cast<size_t>(blockIdx.x) * nb + k];
  if (lane == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  stage(0);
  stage(1);

  // batch i ends before row block c1, in slot i & 1; row c starts at `row`
  int i = 0, c1 = min(rows, nb);
  const unsigned* row = ring;
  mbar_wait(bars, 0);
  for (int c = 0; c < nb; ++c) {
    if (c == c1) {                                           // the next batch
      ++i;
      c1 = min(c1 + rows, nb);
      row = ring + (i & 1) * slot_words(nb);
      mbar_wait(bars + (i & 1), (i >> 1) & 1);
    }
    // the triangle's columns, loaded ahead of the fold
    unsigned col[32];
    const uint4* c4 = reinterpret_cast<const uint4*>(row + 32 * c);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 x = c4[q];
      col[4 * q] = x.x; col[4 * q + 1] = x.y; col[4 * q + 2] = x.z; col[4 * q + 3] = x.w;
    }
    const unsigned diag = row[32 * c + lane];
    // rows of block c that a kept box of an earlier block overlaps: row
    // r's word of block w AND keep word w, 8 blocks a step; keep words
    // from c on are 0, so the step may run past the row's last block
    unsigned a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
    const uint4* kp = reinterpret_cast<const uint4*>(s_keep);
    const unsigned* rl = row + lane;
#pragma unroll 2
    for (int w = 0; w < c; w += 8) {
      const uint4 k0 = kp[w >> 2], k1 = kp[(w >> 2) + 1];
      a0 |= (rl[32 * w] & k0.x) | (rl[32 * w + 32] & k0.y);
      a1 |= (rl[32 * w + 64] & k0.z) | (rl[32 * w + 96] & k0.w);
      a2 |= (rl[32 * w + 128] & k1.x) | (rl[32 * w + 160] & k1.y);
      a3 |= (rl[32 * w + 192] & k1.z) | (rl[32 * w + 224] & k1.w);
    }
    const unsigned nz = __ballot_sync(FULL, diag != 0u);
    unsigned alive = ~(s_dead[c] | __ballot_sync(FULL, (a0 | a1 | a2 | a3) != 0u));
    // the block's own triangle, box by box, when an alive box suppresses
    // one: a chain of register operations with no branch
    if (alive & nz) {
#pragma unroll
      for (int l = 0; l < 31; ++l)                           // box 31 suppresses no row of its block
        alive &= ~(col[l] & (0u - ((alive >> l) & 1u)));
    }
    if (lane == 0) s_keep[c] = alive;
    __syncwarp();
    row += 32 * (c + 1);
    // the batch's slot is read for the last time: refill it
    if (c + 1 == c1) stage(i + 2);
  }
  uint8_t* out = keep_out + static_cast<size_t>(blockIdx.x) * K;
  for (int j = lane; j < K; j += 32)
    out[j] = static_cast<uint8_t>((s_keep[j >> 5] >> (j & 31)) & 1u);
}

// Raises the walk's dynamic shared-memory limit once a device, to what
// K = KMAX needs.
cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  static std::once_flag once[MAX_DEVICES];
  static cudaError_t status[MAX_DEVICES];
  std::call_once(once[dev], [dev] {
    int most = 0;
    for (int nb = 1; nb <= row_blocks(KMAX); ++nb)
      most = max(most, static_cast<int>(sizeof(unsigned)) * walk_smem_words(nb));
    status[dev] = cudaFuncSetAttribute(nms_walk_rows,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  });
  return status[dev];
}

// the scratch: B frames' tiles, then B frames' dead words
unsigned* dead_words(void* scratch, int B, int K) {
  return static_cast<unsigned*>(scratch) + static_cast<size_t>(B) * tiles_of(row_blocks(K)) * 32;
}

int launch_pack(const void* boxes, const void* valid, void* scratch, int B, int K, float thr,
                cudaStream_t st) {
  const int tasks = tiles_of(row_blocks(K)) * (32 / PACK_ROWS);
  const dim3 grid((tasks + PACK_WARPS - 1) / PACK_WARPS, B);
  nms_pack_iou<<<grid, 32 * PACK_WARPS, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned*>(scratch), dead_words(scratch, B, K), K, thr);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int K) { return B < 1 || B > 65535 || K < 1 || K > KMAX; }

}  // namespace

// The pack alone: boxes (B, K, 4), valid (B, K) -> scratch: tiles
// (B, NT, 32), then dead words (B, nb).
extern "C" int tscd_nms_pack(const void* boxes, const void* valid, void* scratch, int B, int K,
                             float thr, void* stream) {
  if (bad_shape(B, K)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pack(boxes, valid, scratch, B, K, thr, static_cast<cudaStream_t>(stream));
}

// The pack, then the walk: boxes (B, K, 4), valid (B, K) -> keep (B, K).
extern "C" int tscd_nms_sorted(const void* boxes, const void* valid, void* scratch,
                               void* keep, int B, int K, float thr, void* stream) {
  if (bad_shape(B, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_pack(boxes, valid, scratch, B, K, thr, st);
  if (rc != 0) return rc;
  const size_t smem = sizeof(unsigned) * walk_smem_words(row_blocks(K));
  nms_walk_rows<<<B, 32, smem, st>>>(static_cast<const unsigned*>(scratch),
                                     dead_words(scratch, B, K), static_cast<uint8_t*>(keep), K);
  return static_cast<int>(cudaGetLastError());
}
