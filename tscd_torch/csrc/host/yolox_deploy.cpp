// Grid decode and greedy class-aware NMS of a raw YOLOX head output, on
// the host (counterpart of tscd_tpu/native/yolox_deploy.cpp, the same
// arithmetic in the same order).
//
// Given the raw dense output (A, 5 + C) of an exported YOLOX (`python -m
// tscd_torch.tools.export --raw`: reg, obj and class LOGITS), decodes each
// anchor on its level's grid and runs greedy class-aware NMS. Bound through
// ctypes by tscd_torch/utils/native.py (`yolox_decode_nms`) and compiled
// into the AOTInductor runner (csrc/host/aoti_runner.cpp).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (tscd_torch/utils/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Det {
  float x1, y1, x2, y2, score;
  int cls;
};

}  // namespace

extern "C" {

// Decode raw YOLOX head output (A, 5+C) — raw reg, obj/cls LOGITS —
// into detections, then greedy class-aware NMS.
//   hw:      (L*2) [h0,w0,h1,w1,...] per-level grid sizes
//   strides: (L)
//   out:     (max_out * 7) rows [x1,y1,x2,y2,obj_score,cls_score,cls]
// Returns the number of detections written.
int32_t yolox_decode_nms(
    const float* raw, int64_t A, int64_t C,
    const int32_t* hw, const int32_t* strides, int64_t L,
    float conf_thresh, float nms_thresh, int32_t max_out,
    float* out) {
  const int64_t K = 5 + C;
  std::vector<Det> cands;
  int64_t a = 0;
  for (int64_t l = 0; l < L; ++l) {
    const int32_t h = hw[2 * l], w = hw[2 * l + 1], s = strides[l];
    for (int32_t gy = 0; gy < h; ++gy) {
      for (int32_t gx = 0; gx < w; ++gx, ++a) {
        const float* r = raw + a * K;
        const float obj = 1.f / (1.f + std::exp(-r[4]));
        if (obj * 1.0f < conf_thresh) continue;  // quick reject
        int best_c = 0;
        float best_logit = r[5];
        for (int64_t c = 1; c < C; ++c)
          if (r[5 + c] > best_logit) { best_logit = r[5 + c]; best_c = c; }
        const float cls = 1.f / (1.f + std::exp(-best_logit));
        if (obj * cls < conf_thresh) continue;
        const float cx = (r[0] + gx) * s;
        const float cy = (r[1] + gy) * s;
        const float bw = std::exp(r[2]) * s;
        const float bh = std::exp(r[3]) * s;
        cands.push_back({cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2, obj * cls, best_c});
      }
    }
  }
  std::sort(cands.begin(), cands.end(),
            [](const Det& x, const Det& y) { return x.score > y.score; });
  std::vector<Det> kept;
  for (const Det& d : cands) {
    bool ok = true;
    for (const Det& k : kept) {
      if (k.cls != d.cls) continue;
      const float ix = std::max(0.f, std::min(d.x2, k.x2) -
                                         std::max(d.x1, k.x1));
      const float iy = std::max(0.f, std::min(d.y2, k.y2) -
                                         std::max(d.y1, k.y1));
      const float inter = ix * iy;
      const float uni = (d.x2 - d.x1) * (d.y2 - d.y1) +
                        (k.x2 - k.x1) * (k.y2 - k.y1) - inter;
      if (uni > 0 && inter / uni > nms_thresh) { ok = false; break; }
    }
    if (!ok) continue;
    kept.push_back(d);
    if ((int32_t)kept.size() >= max_out) break;
  }
  for (size_t i = 0; i < kept.size(); ++i) {
    float* o = out + i * 7;
    o[0] = kept[i].x1; o[1] = kept[i].y1;
    o[2] = kept[i].x2; o[3] = kept[i].y2;
    o[4] = 1.0f;                 // obj folded into score
    o[5] = kept[i].score;
    o[6] = (float)kept[i].cls;
  }
  return (int32_t)kept.size();
}

}  // extern "C"
