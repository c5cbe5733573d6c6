"""The port's copy of tscd_tpu/utils/demo_utils.py (numpy; no JAX).

Numpy post-processing for deployment pipelines (reference:
yolox/utils/demo_utils.py — multiclass_nms:49 and helpers used by the
ONNX/OpenVINO demos). Pure numpy; pairs with tools/export.py artifacts
when the consumer runtime has no JAX."""

from typing import Optional, Tuple

import numpy as np


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              nms_thr: float) -> list:
    """Single-class NMS (demo_utils.py nms)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= nms_thr]
    return keep


def multiclass_nms(boxes: np.ndarray, scores: np.ndarray,
                   nms_thr: float, score_thr: float,
                   class_agnostic: bool = False) -> Optional[np.ndarray]:
    """(demo_utils.py:49) boxes (N,4), scores (N,C) ->
    (K, 6) [x1,y1,x2,y2,score,cls] or None."""
    final = []
    if class_agnostic:
        cls_inds = scores.argmax(1)
        cls_scores = scores[np.arange(len(scores)), cls_inds]
        valid = cls_scores > score_thr
        if valid.sum() == 0:
            return None
        vb, vs, vc = boxes[valid], cls_scores[valid], cls_inds[valid]
        keep = nms_numpy(vb, vs, nms_thr)
        if keep:
            final.append(np.concatenate(
                [vb[keep], vs[keep, None], vc[keep, None]], 1))
    else:
        for c in range(scores.shape[1]):
            cs = scores[:, c]
            valid = cs > score_thr
            if valid.sum() == 0:
                continue
            vb, vs = boxes[valid], cs[valid]
            keep = nms_numpy(vb, vs, nms_thr)
            if keep:
                cls = np.full((len(keep), 1), c, dtype=np.float32)
                final.append(np.concatenate(
                    [vb[keep], vs[keep, None], cls], 1))
    if not final:
        return None
    return np.concatenate(final, 0)


def demo_postprocess(outputs: np.ndarray, img_size: Tuple[int, int],
                     strides=(8, 16, 32)) -> np.ndarray:
    """Grid-decode raw (A, 5+C) outputs in numpy (demo_utils
    demo_postprocess): reg raw -> cxcywh pixels; obj/cls assumed already
    sigmoided by the exporter."""
    grids, expanded = [], []
    for s in strides:
        h, w = img_size[0] // s, img_size[1] // s
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grids.append(np.stack([xx, yy], -1).reshape(-1, 2))
        expanded.append(np.full((h * w, 1), s))
    grid = np.concatenate(grids, 0)
    stride = np.concatenate(expanded, 0)
    out = outputs.copy()
    out[..., :2] = (outputs[..., :2] + grid) * stride
    out[..., 2:4] = np.exp(outputs[..., 2:4]) * stride
    return out
