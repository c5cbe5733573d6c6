"""COCO-style detection evaluation (bbox), pycocotools-compatible (a copy
of tscd_tpu/eval/cocoeval.py).

Per-image greedy score-ordered GT<->DT matching at 10 IoU thresholds,
101-point precision interpolation, area-range and maxDet breakdowns, in
numpy. `tscd_torch.eval.fast_cocoeval.COCOeval_opt` runs evaluate and
accumulate natively with identical results.
"""

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def bbox_iou_xywh(dts: np.ndarray, gts: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """(D,4),(G,4) xywh -> (D,G) IoU; crowd gts use intersection/dt_area."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    da = (dts[:, 2] * dts[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class Params:
    def __init__(self):
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e10], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.useCats = 1


class COCOeval:
    """Evaluate detections (same public surface as pycocotools COCOeval
    for iouType='bbox': evaluate/accumulate/summarize + .stats)."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        if iouType != "bbox":
            raise ValueError(f"only iouType='bbox' is supported, got {iouType!r}")
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params()
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats = np.zeros(12)

    def _prepare(self):
        p = self.params
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for img_id in p.imgIds:
            for ann in self.cocoGt.imgToAnns[img_id]:
                self._gts[(img_id, ann["category_id"])].append(ann)
            for ann in self.cocoDt.imgToAnns[img_id]:
                self._dts[(img_id, ann["category_id"])].append(ann)

    def evaluate(self):
        p = self.params
        self._prepare()
        maxDet = p.maxDets[-1]
        self.evalImgs = {}
        for cat_id in p.catIds:
            for img_id in p.imgIds:
                self.evalImgs[(img_id, cat_id)] = self._evaluate_img(
                    img_id, cat_id, maxDet)

    def _evaluate_img(self, img_id, cat_id, maxDet):
        p = self.params
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if len(gts) == 0 and len(dts) == 0:
            return None
        dts = sorted(dts, key=lambda d: -d["score"])[:maxDet]
        g_boxes = np.array([g["bbox"] for g in gts]).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dts]).reshape(-1, 4)
        g_crowd = np.array([g.get("iscrowd", 0) for g in gts], bool)
        g_ignore_base = np.array(
            [g.get("ignore", 0) or g.get("iscrowd", 0) for g in gts], bool)
        g_area = np.array([g.get("area", g["bbox"][2] * g["bbox"][3])
                           for g in gts])
        d_area = np.array([d["bbox"][2] * d["bbox"][3] for d in dts])
        scores = np.array([d["score"] for d in dts])
        ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd)

        T = len(p.iouThrs)
        A = len(p.areaRng)
        D, G = len(dts), len(gts)
        # per area range
        result = {"dtScores": scores, "num_dt": D, "num_gt": G}
        for a, rng in enumerate(p.areaRng):
            g_ig = g_ignore_base | (g_area < rng[0]) | (g_area > rng[1])
            # sort gts: non-ignored first (pycocotools order)
            g_order = np.argsort(g_ig, kind="stable")
            dtm = np.zeros((T, D), dtype=np.int64)       # matched gt id or 0
            dt_ig = np.zeros((T, D), bool)
            gtm = np.zeros((T, G), dtype=np.int64)
            for t, thr in enumerate(p.iouThrs):
                for d in range(D):
                    best_iou = min(thr, 1 - 1e-10)
                    best_g = -1
                    for gi in g_order:
                        if gtm[t, gi] and not g_crowd[gi]:
                            continue
                        # can't match ignored gt after matching real gt
                        if best_g > -1 and not g_ig[best_g] and g_ig[gi]:
                            break
                        if ious[d, gi] < best_iou:
                            continue
                        best_iou = ious[d, gi]
                        best_g = gi
                    if best_g == -1:
                        continue
                    dt_ig[t, d] = g_ig[best_g]
                    dtm[t, d] = best_g + 1
                    gtm[t, best_g] = d + 1
            out_of_rng = (d_area < rng[0]) | (d_area > rng[1])
            dt_ig_final = dt_ig | ((dtm == 0) & out_of_rng[None])
            result[a] = {
                "dtMatches": dtm, "dtIgnore": dt_ig_final,
                "gtIgnore": g_ig, "num_nonignored_gt": int((~g_ig).sum()),
            }
        return result

    def accumulate(self):
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores_out = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(p.catIds):
            per_img = [self.evalImgs.get((img_id, cat_id))
                       for img_id in p.imgIds]
            per_img = [e for e in per_img if e is not None]
            if not per_img:
                continue
            for a in range(A):
                for m, maxDet in enumerate(p.maxDets):
                    dt_scores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in per_img])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[order]
                    dtm = np.concatenate(
                        [e[a]["dtMatches"][:, :maxDet] for e in per_img],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e[a]["dtIgnore"][:, :maxDet] for e in per_img],
                        axis=1)[:, order]
                    npig = sum(e[a]["num_nonignored_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, p.recThrs, side="left")
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        precision[t, :, k, a, m] = q
                        scores_out[t, :, k, a, m] = ss
        self.eval = {
            "params": p, "precision": precision, "recall": recall,
            "scores": scores_out,
        }

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        s = self._summarize
        self.stats = np.array([
            s(1), s(1, 0.5), s(1, 0.75),
            s(1, areaRng="small"), s(1, areaRng="medium"),
            s(1, areaRng="large"),
            s(0, maxDets=1), s(0, maxDets=10), s(0, maxDets=100),
            s(0, areaRng="small"), s(0, areaRng="medium"),
            s(0, areaRng="large"),
        ])
        return self.stats

    def per_class_ap(self, iouThr=None) -> Dict[str, float]:
        """Per-category AP table (reference coco_evaluator.py
        per_class_AP_table)."""
        p = self.params
        out = {}
        prec = self.eval["precision"]
        for k, cat_id in enumerate(p.catIds):
            s = prec[:, :, k, 0, -1]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            valid = s[s > -1]
            name = (self.cocoGt.cats[cat_id]["name"]
                    if self.cocoGt and cat_id in self.cocoGt.cats
                    else str(cat_id))
            out[name] = float(np.mean(valid)) * 100 if valid.size else float("nan")
        return out

    def per_class_ar(self, iouThr=None) -> Dict[str, float]:
        """Per-category AR table (reference coco_evaluator.py
        per_class_AR_table)."""
        p = self.params
        out = {}
        rec = self.eval["recall"]
        for k, cat_id in enumerate(p.catIds):
            s = rec[:, k, 0, -1]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            valid = s[s > -1]
            name = (self.cocoGt.cats[cat_id]["name"]
                    if self.cocoGt and cat_id in self.cocoGt.cats
                    else str(cat_id))
            out[name] = float(np.mean(valid)) * 100 if valid.size else float("nan")
        return out
