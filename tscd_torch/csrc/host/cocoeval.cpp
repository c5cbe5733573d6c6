// Fast COCO bbox evaluation — native core.
//
// C++ counterpart of the reference's pybind11 torch extension
// (yolox/layers/cocoeval/cocoeval.cpp, COCOevalEvaluateImages): the
// per-image greedy score-ordered GT<->DT matching at T IoU thresholds
// and A area ranges, which dominates pure-python evaluation time.
// Exposed through a plain C ABI (ctypes — no pybind11/torch in this
// build); tscd_torch/eval/fast_cocoeval.py builds it with g++ at first
// use, does the marshalling, and raises if the build fails.
// A copy of tscd_tpu/native/cocoeval.cpp; host code, no CUDA.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC cocoeval.cpp -o libcocoeval.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double iou_xywh(const double* d, const double* g, bool crowd) {
  const double dx1 = d[0], dy1 = d[1], dx2 = d[0] + d[2], dy2 = d[1] + d[3];
  const double gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
  const double ix = std::max(0.0, std::min(dx2, gx2) - std::max(dx1, gx1));
  const double iy = std::max(0.0, std::min(dy2, gy2) - std::max(dy1, gy1));
  const double inter = ix * iy;
  const double da = d[2] * d[3];
  const double ga = g[2] * g[3];
  const double uni = crowd ? da : da + ga - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// Evaluate one (image, category) pair.
//
// Inputs (detections MUST be pre-sorted by descending score):
//   d_boxes  (D*4)  xywh          g_boxes  (G*4) xywh
//   g_crowd  (G)    0/1           g_ignore (G)   0/1 (ignore|iscrowd)
//   g_area   (G)                  d_area   (D)
//   iou_thrs (T)                  area_rng (A*2) [lo, hi]
// Outputs (caller-allocated):
//   dtm    (A*T*D) int64 — matched gt index + 1, or 0
//   dt_ig  (A*T*D) uint8 — detection-ignored flag (incl. area gating)
//   g_ig   (A*G)   uint8 — per-area gt ignore flags
//   npig   (A)     int32 — non-ignored gt count per area range
void cocoeval_evaluate_img(
    const double* d_boxes, const double* d_area, int64_t D,
    const double* g_boxes, const uint8_t* g_crowd, const uint8_t* g_ignore,
    const double* g_area, int64_t G,
    const double* iou_thrs, int64_t T,
    const double* area_rng, int64_t A,
    int64_t* dtm, uint8_t* dt_ig, uint8_t* g_ig_out, int32_t* npig) {
  // IoU matrix once per pair
  std::vector<double> ious(static_cast<size_t>(D) * G);
  for (int64_t d = 0; d < D; ++d)
    for (int64_t g = 0; g < G; ++g)
      ious[d * G + g] =
          iou_xywh(d_boxes + 4 * d, g_boxes + 4 * g, g_crowd[g] != 0);

  std::vector<uint8_t> g_ig(G);
  std::vector<int64_t> g_order(G);
  std::vector<int64_t> gtm(G);

  for (int64_t a = 0; a < A; ++a) {
    const double lo = area_rng[2 * a], hi = area_rng[2 * a + 1];
    int32_t nonignored = 0;
    for (int64_t g = 0; g < G; ++g) {
      g_ig[g] = g_ignore[g] || g_area[g] < lo || g_area[g] > hi;
      g_ig_out[a * G + g] = g_ig[g];
      if (!g_ig[g]) ++nonignored;
    }
    npig[a] = nonignored;
    // stable sort: non-ignored gts first (pycocotools order)
    for (int64_t g = 0; g < G; ++g) g_order[g] = g;
    std::stable_sort(g_order.begin(), g_order.end(),
                     [&](int64_t x, int64_t y) { return g_ig[x] < g_ig[y]; });

    for (int64_t t = 0; t < T; ++t) {
      std::fill(gtm.begin(), gtm.end(), 0);
      int64_t* dtm_at = dtm + (a * T + t) * D;
      uint8_t* dig_at = dt_ig + (a * T + t) * D;
      for (int64_t d = 0; d < D; ++d) {
        double best_iou = std::min(iou_thrs[t], 1.0 - 1e-10);
        int64_t best_g = -1;
        for (int64_t oi = 0; oi < G; ++oi) {
          const int64_t g = g_order[oi];
          if (gtm[g] && !g_crowd[g]) continue;
          // once matched to a real gt, never switch to an ignored one
          if (best_g > -1 && !g_ig[best_g] && g_ig[g]) break;
          const double iou = ious[d * G + g];
          if (iou < best_iou) continue;
          best_iou = iou;
          best_g = g;
        }
        if (best_g == -1) {
          dtm_at[d] = 0;
          dig_at[d] = (d_area[d] < lo || d_area[d] > hi) ? 1 : 0;
          continue;
        }
        dig_at[d] = g_ig[best_g];
        dtm_at[d] = best_g + 1;
        gtm[best_g] = d + 1;
      }
    }
  }
}

// Accumulate one (cat, area, maxDet) cell: given concatenated
// score-sorted dt matches/ignores for T thresholds, produce the
// 101-point interpolated precision/scores and final recall.
//   dtm, dt_ig: (T*N);  rec_thrs: (R)
//   precision, scores_out: (T*R);  recall: (T)
void cocoeval_accumulate_cell(
    const int64_t* dtm, const uint8_t* dt_ig, const double* dt_scores,
    int64_t T, int64_t N, int64_t npig,
    const double* rec_thrs, int64_t R,
    double* precision, double* scores_out, double* recall) {
  // full-length rc/pr arrays — ignored detections keep their slots
  // (zero increments), exactly like pycocotools' cumsum over all N,
  // so searchsorted indices and the scores output match the python
  // implementation bit for bit.
  std::vector<double> pr(N), rc(N);
  for (int64_t t = 0; t < T; ++t) {
    const int64_t* m = dtm + t * N;
    const uint8_t* ig = dt_ig + t * N;
    double tp = 0, fp = 0;
    for (int64_t i = 0; i < N; ++i) {
      if (!ig[i]) {
        if (m[i] > 0) ++tp; else ++fp;
      }
      rc[i] = tp / npig;
      pr[i] = tp / std::max(tp + fp, 2.220446049250313e-16);
    }
    recall[t] = N ? rc[N - 1] : 0.0;
    for (int64_t i = N - 2; i >= 0; --i) pr[i] = std::max(pr[i], pr[i + 1]);
    for (int64_t r = 0; r < R; ++r) {
      const int64_t pi =
          std::lower_bound(rc.begin(), rc.begin() + N, rec_thrs[r]) -
          rc.begin();
      if (pi < N) {
        precision[t * R + r] = pr[pi];
        scores_out[t * R + r] = dt_scores[pi];
      } else {
        precision[t * R + r] = 0.0;
        scores_out[t * R + r] = 0.0;
      }
    }
  }
}

}  // extern "C"
