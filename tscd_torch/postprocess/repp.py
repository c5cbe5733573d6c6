"""The port's copy of tscd_tpu/postprocess/repp.py (numpy; no JAX).

REPP — Robust and Efficient Post-Processing for video object detection
(reference: tools/REPPM.py:27, tools/repp_utils.py, tools/REPP.py).

Offline, host-side numpy (the reference runs it as a multiprocessing CPU
stage after val_to_imdb): per video,
  1. score filtering (min_pred_score),
  2. cross-frame pair linking between consecutive frames — either the
     baseline IoU·score distance (REPPM.py:72 distance_def) or a
     logistic-regression classifier over pair features
     (repp_utils.get_pair_features:31, REPPM.py:80 distance_logreg),
  3. greedy distance-matrix solving (REPPM.py:156),
  4. tubelet building (:179),
  5. tubelet re-scoring by the mean per-class score (:231),
  6. Gaussian-smoothed re-coordinating of boxes along the tubelet (:244).

Detections are per-frame dicts {"bbox": [x, y, w, h] (pixels),
"scores": (C,) per-class score vector} or (K, 7) rows
[x1,y1,x2,y2,obj,score,cls] via `rows_to_repp`.
"""

import math
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np


def iou_xywh(b1, b2) -> float:
    x11, y11, x12, y12 = b1[0], b1[1], b1[0] + b1[2], b1[1] + b1[3]
    x21, y21, x22, y22 = b2[0], b2[1], b2[0] + b2[2], b2[1] + b2[3]
    ix = max(0.0, min(x12, x22) - max(x11, x21))
    iy = max(0.0, min(y12, y22) - max(y11, y21))
    inter = ix * iy
    union = b1[2] * b1[3] + b2[2] * b2[3] - inter
    return inter / union if union > 0 else 0.0


def get_pair_features(det1: dict, det2: dict,
                      feat_names: Sequence[str] = ()) -> dict:
    """Pair descriptors between two detections in consecutive frames —
    exact reference feature set (repp_utils.get_pair_features:31):
    width_rel/height_rel (min/max side ratios), IoU, euclidean distance
    between normalized bbox centers, and (when 'emb' descriptors exist)
    descriptor L2 distance. Empty feat_names = all available."""
    b1, b2 = np.asarray(det1["bbox"], float), np.asarray(det2["bbox"], float)
    feats = {}
    want = lambda n: n in feat_names or len(feat_names) == 0
    if want("width_rel"):
        feats["width_rel"] = min(b1[2], b2[2]) / max(b1[2], b2[2])
    if want("height_rel"):
        feats["height_rel"] = min(b1[3], b2[3]) / max(b1[3], b2[3])
    if want("iou"):
        feats["iou"] = iou_xywh(b1, b2)
    if want("center_distances_corrected"):
        c1 = det1.get("bbox_center",
                      (b1[0] + b1[2] / 2, b1[1] + b1[3] / 2))
        c2 = det2.get("bbox_center",
                      (b2[0] + b2[2] / 2, b2[1] + b2[3] / 2))
        feats["center_distances_corrected"] = math.sqrt(
            (c2[0] - c1[0]) ** 2 + (c2[1] - c1[1]) ** 2)
    if (want("descriptor_dist") and "emb" in det1 and "emb" in det2):
        feats["descriptor_dist"] = float(np.linalg.norm(
            np.asarray(det1["emb"]) - np.asarray(det2["emb"])))
    return feats


# default feature order for models trained by tools/train_repp_clf.py
PAIR_FEATURE_ORDER = ("width_rel", "height_rel", "iou",
                      "center_distances_corrected")


def load_pair_classifier(path: str):
    """Load the pair classifier as (predict_proba_fn, feat_names).

    Formats: the reference's matching_model_logreg.pckl — a pickled
    (sklearn classifier, feature-name list) tuple (REPPM.py:60-62) —
    or a dependency-free JSON {"coef": [...], "intercept": x,
    "feats": [...]} written by tools/train_repp_clf.py."""
    import json
    import os
    if path.endswith(".json") or not os.path.splitext(path)[1]:
        with open(path) as f:
            m = json.load(f)
        coef = np.asarray(m["coef"], float).reshape(1, -1)
        intercept = float(np.asarray(m["intercept"]).reshape(-1)[0])
        feats = tuple(m["feats"])

        def predict_proba(x):
            p = 1.0 / (1.0 + np.exp(-(np.asarray(x) @ coef.T + intercept)))
            return np.concatenate([1.0 - p, p], axis=1)

        return predict_proba, feats
    with open(path, "rb") as f:
        clf, feats = pickle.load(f)
    return clf.predict_proba, tuple(feats)


def rows_to_repp(rows: np.ndarray, num_classes: int,
                 image_size: Sequence[float] = (1.0, 1.0)) -> List[dict]:
    """(K, 7) [x1,y1,x2,y2,obj,score,cls] -> per-detection REPP dicts with
    one-hot-ish score vectors (obj*score at the predicted class)."""
    out = []
    w = float(image_size[0]) or 1.0
    h = float(image_size[1]) or 1.0
    for r in np.asarray(rows, float):
        scores = np.zeros(num_classes)
        scores[int(r[6])] = r[4] * r[5]
        out.append({"bbox": [r[0], r[1], r[2] - r[0], r[3] - r[1]],
                    "bbox_center": [(r[0] + r[2]) / 2 / max(w, h),
                                    (r[1] + r[3]) / 2 / max(w, h)],
                    "scores": scores})
    return out


class REPP:
    def __init__(self, min_tubelet_score: float = 0.3,
                 min_pred_score: float = 0.01,
                 clf_threshold: float = 0.7,
                 clf_mode: str = "dot",
                 recoordinate: bool = True,
                 recoordinate_std: float = 1.0,
                 clf_model_path: Optional[str] = None,
                 image_size: Sequence[float] = (1.0, 1.0),
                 add_unmatched: bool = False,
                 post: bool = True):
        """Defaults mirror tools/yolo_repp_cfg.json (clf_thr 0.7,
        clf_mode 'dot'); no model file -> the baseline IoU-score
        distance. Threshold roles match the reference exactly
        (end-to-end parity: tests/test_repp_parity.py):
        `min_tubelet_score` filters the INPUT detections (REPPM.py:
        301-310 — despite its name), `min_pred_score` filters exported
        predictions (tubelets_to_predictions, :268). `add_unmatched`
        keeps the reference's inverted sense: FALSE adds unlinked
        detections back as singleton tubelets (:323-325). `post=False`
        skips linking entirely (every det becomes its own tubelet —
        REPPM.get_pred, :155, the `--post` off mode)."""
        self.min_tubelet_score = min_tubelet_score
        self.min_pred_score = min_pred_score
        self.clf_threshold = clf_threshold
        self.clf_mode = clf_mode
        self.do_recoordinate = recoordinate
        self.recoordinate_std = recoordinate_std
        self.image_size = image_size
        self.add_unmatched = add_unmatched
        self.post = post
        self.clf = None
        self.matching_feats = PAIR_FEATURE_ORDER
        if clf_model_path:
            self.clf, self.matching_feats = load_pair_classifier(
                clf_model_path)

    # -- pair distances ----------------------------------------------------
    def distance_def(self, det1: dict, det2: dict) -> float:
        """Baseline: 1 / (IoU * score dot product), inf when either is 0
        (REPPM.py:72-77)."""
        iou = iou_xywh(det1["bbox"], det2["bbox"])
        score = float(np.dot(det1["scores"], det2["scores"]))
        div = iou * score
        return 1.0 / div if div > 0 else float("inf")

    def distance_logreg(self, det1: dict, det2: dict) -> float:
        """Logistic-regression pair classifier (REPPM.py:80-101):
        P(link) from pair features, inf below clf_threshold, then the
        clf_mode score combination; distance = 1 - score."""
        feats = get_pair_features(det1, det2, self.matching_feats)
        x = np.asarray([[feats[k] for k in self.matching_feats]])
        score = float(self.clf(x)[0, 1])
        if score < self.clf_threshold:
            return float("inf")
        s1, s2 = np.asarray(det1["scores"]), np.asarray(det2["scores"])
        if self.clf_mode == "max":
            score = float(s1.max() * s2.max()) * score
        elif self.clf_mode == "dot":
            score = float(np.dot(s1, s2)) * score
        elif self.clf_mode == "dot_plus":
            score = float(np.dot(s1, s2)) + score
        elif self.clf_mode == "raw":
            pass
        else:
            raise ValueError(f"clf_mode {self.clf_mode!r} not recognized")
        return 1.0 - score

    def distance(self, det1, det2):
        return (self.distance_logreg(det1, det2) if self.clf is not None
                else self.distance_def(det1, det2))

    # -- linking -----------------------------------------------------------
    def get_video_pairs(self, video_dets: List[List[dict]]):
        """For each pair of consecutive frames: greedy min-distance
        matching (REPPM.py:103,156). Returns (pairs, unmatched): per
        frame-gap, the matched (i, j) tuples in greedy-discovery order,
        and the frame-f det indices that are not a link SOURCE (tubelet
        tails count as unmatched too — reference :128). Note the last
        frame gets NO unmatched entry (the reference's loop runs gaps
        0..n-2 only)."""
        pairs, unmatched = [], []
        for f in range(len(video_dets) - 1):
            d1, d2 = video_dets[f], video_dets[f + 1]
            links = []
            if d1 and d2:
                mat = np.full((len(d1), len(d2)), np.inf)
                for i, a in enumerate(d1):
                    for j, b in enumerate(d2):
                        mat[i, j] = self.distance(a, b)
                while np.isfinite(mat).any():
                    i, j = np.unravel_index(np.argmin(mat), mat.shape)
                    links.append((int(i), int(j)))
                    mat[i, :] = np.inf
                    mat[:, j] = np.inf
            srcs = {p[0] for p in links}
            pairs.append(links)
            unmatched.append([i for i in range(len(d1)) if i not in srcs])
        return pairs, unmatched

    @staticmethod
    def get_identity_pairs(video_dets: List[List[dict]]):
        """post=False: no linking — empty pair lists, every det of every
        frame (INCLUDING the last, unlike get_video_pairs) unmatched
        (REPPM.get_pred, :135-154)."""
        n = len(video_dets)
        pairs = [[] for _ in range(max(n - 1, 0))]
        unmatched = [list(range(len(d))) for d in video_dets]
        return pairs, unmatched

    def get_tubelets(self, video_dets: List[List[dict]], pairs):
        """Maximal chains over the pair links, discovered in
        (start-frame, pair-discovery-order) order, consuming pairs as
        they are chained (REPPM.py:179-230). Only linked detections form
        chains here; unlinked ones enter via `add_unmatched` handling in
        __call__."""
        pairs = [list(p) for p in pairs]
        tubelets = []
        n = len(video_dets)
        f = 0
        while f < max(n - 1, 0):
            if not pairs[f]:
                f += 1
                continue
            i, j = pairs[f].pop(0)
            tube = [(f, video_dets[f][i])]
            cur, ind = f + 1, j
            while cur < n - 1:
                nxt = next((p for p in pairs[cur] if p[0] == ind), None)
                if nxt is None:
                    break
                pairs[cur].remove(nxt)
                tube.append((cur, video_dets[cur][ind]))
                ind = nxt[1]
                cur += 1
            tube.append((cur, video_dets[cur][ind]))
            tubelets.append(tube)
        return tubelets

    # -- rescoring / recoordinating -----------------------------------------
    @staticmethod
    def rescore_tubelet(tube):
        """Mean per-class score across the tubelet replaces each det's
        scores, IN PLACE on the shared det dicts (REPPM.py:231)."""
        mean_scores = np.mean([d["scores"] for _, d in tube], axis=0)
        for _, d in tube:
            d["scores"] = mean_scores.copy()
        return float(np.max(mean_scores))

    def recoordinate_tubelet(self, tube, ms: float = 40.0):
        """Gaussian smoothing of box coords along time, matching the
        reference kernel exactly (REPPM.py:244-258): window length
        2*len-1, std = recoordinate_std * 100 / 40, reflect boundary
        (scipy.ndimage 'reflect' == np.pad 'symmetric')."""
        coords = np.asarray([d["bbox"] for _, d in tube], float)
        L = len(coords)
        std = self.recoordinate_std * 100.0 / ms
        n = np.arange(2 * L - 1) - (L - 1)
        kernel = np.exp(-0.5 * (n / std) ** 2)
        kernel /= kernel.sum()
        sm = np.stack([np.convolve(
            np.pad(coords[:, k], L - 1, mode="symmetric"), kernel,
            mode="valid") for k in range(4)], axis=1)
        for (f, d), row in zip(tube, sm):
            d["bbox"] = row.tolist()

    # -- top-level -----------------------------------------------------------
    def __call__(self, video_dets: List[List[dict]]) -> List[List[dict]]:
        """video_dets: per-frame lists of REPP detection dicts. Returns
        per-frame lists after the reference pipeline (REPPM.__call__,
        :299-340): input filter at min_tubelet_score -> link -> chain ->
        rescore -> recoordinate -> re-add unlinked dets as singleton
        tubelets (when add_unmatched is False — the reference's inverted
        flag). A tubelet TAIL also appears in the unmatched set, so the
        same (rescored, shared) det dict is emitted twice — reference
        behavior, kept for output parity; export-level filtering happens
        in repp_to_coco / process_video_dets at min_pred_score."""
        filtered = [[d for d in frame
                     if np.max(d["scores"]) >= self.min_tubelet_score]
                    for frame in video_dets]
        if self.post:
            pairs, unmatched = self.get_video_pairs(filtered)
        else:
            pairs, unmatched = self.get_identity_pairs(filtered)
        tubelets = self.get_tubelets(filtered, pairs)
        for tube in tubelets:
            self.rescore_tubelet(tube)
        if self.do_recoordinate:
            for tube in tubelets:
                self.recoordinate_tubelet(tube)
        if not self.add_unmatched:
            for f, rows in enumerate(unmatched):
                for i in rows:
                    tubelets.append([(f, filtered[f][i])])
        out: List[List[dict]] = [[] for _ in video_dets]
        for tube in tubelets:
            for f, d in tube:
                out[f].append(d)
        return out

    def process_video_dets(self, all_dets: List[Optional[np.ndarray]],
                           num_classes: int = 30):
        """Convenience wrapper over (K, 7) row arrays per frame (the demo
        path): REPP then back to row format, with the export-level
        min_pred_score / max-class filter (tubelets_to_predictions,
        REPPM.py:264-270)."""
        video = [rows_to_repp(d if d is not None else np.zeros((0, 7)),
                              num_classes) for d in all_dets]
        processed = self(video)
        out = []
        for frame in processed:
            rows = []
            for d in frame:
                cls = int(np.argmax(d["scores"]))
                s = float(d["scores"][cls])
                if s < self.min_pred_score:
                    continue
                x, y, w, h = d["bbox"]
                rows.append([x, y, x + w, y + h, 1.0, s, cls])
            out.append(np.asarray(rows, np.float32).reshape(-1, 7))
        return out


def repp_to_coco(video_dets: List[List[dict]], image_ids: List[int],
                 class_ids: Optional[Sequence[int]] = None,
                 min_pred_score: float = 0.0) -> List[dict]:
    """Per-frame REPP dicts -> COCO prediction dicts
    (tubelets_to_predictions, REPPM.py:260-276): keeps every class slot
    tied at the max score (usually exactly one) when it clears
    min_pred_score."""
    out = []
    for frame, img_id in zip(video_dets, image_ids):
        for d in frame:
            smax = float(np.max(d["scores"]))
            for cls, s in enumerate(np.asarray(d["scores"], float)):
                if s < min_pred_score or s != smax:
                    continue
                out.append({
                    "image_id": int(img_id),
                    "category_id": (int(class_ids[cls]) if class_ids
                                    else cls + 1),
                    "bbox": [float(v) for v in d["bbox"]],
                    "score": float(s),
                })
    return out
