"""COCOeval with native evaluate/accumulate (counterpart of
tscd_tpu/eval/fast_cocoeval.py; reference fast_coco_eval_api.py:17).

The per-image greedy matching and the per-cell accumulate loop run in
C++ (tscd_torch/csrc/host/cocoeval.cpp, host code), built with g++ at
first use into `build/native/` and loaded with ctypes. Results equal the
numpy `COCOeval`'s. A failed build raises: nothing falls back.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .cocoeval import COCOeval

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "cocoeval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_L = ctypes.c_int64
_SIGNATURES = {
    "cocoeval_evaluate_img": [_P, _P, _L, _P, _P, _P, _P, _L, _P, _L, _P, _L,
                              _P, _P, _P, _P],
    "cocoeval_accumulate_cell": [_P, _P, _P, _L, _L, _L, _P, _L, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libcocoeval_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native COCO evaluation library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".tmp{os.getpid()}")
            r = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = None
        _lib = lib
        return lib


def _cp(a, t):
    return np.ascontiguousarray(a, dtype=t)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class COCOeval_opt(COCOeval):
    """COCOeval with native evaluate/accumulate."""

    def _evaluate_img(self, img_id, cat_id, maxDet):
        lib = load_library()
        p = self.params
        gts = self._gts[(img_id, cat_id)]
        dts = self._dts[(img_id, cat_id)]
        if len(gts) == 0 and len(dts) == 0:
            return None
        dts = sorted(dts, key=lambda d: -d["score"])[:maxDet]
        D, G = len(dts), len(gts)
        T, A = len(p.iouThrs), len(p.areaRng)

        d_boxes = _cp([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        g_boxes = _cp([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        d_area = _cp(d_boxes[:, 2] * d_boxes[:, 3], np.float64)
        g_crowd = _cp([g.get("iscrowd", 0) for g in gts], np.uint8)
        g_ignore = _cp([1 if (g.get("ignore", 0) or g.get("iscrowd", 0))
                        else 0 for g in gts], np.uint8)
        g_area = _cp([g.get("area", g["bbox"][2] * g["bbox"][3])
                      for g in gts], np.float64)
        scores = _cp([d["score"] for d in dts], np.float64)
        iou_thrs = _cp(p.iouThrs, np.float64)
        area_rng = _cp(p.areaRng, np.float64)

        dtm = np.zeros((A, T, D), np.int64)
        dt_ig = np.zeros((A, T, D), np.uint8)
        g_ig = np.zeros((A, G), np.uint8)
        npig = np.zeros((A,), np.int32)
        lib.cocoeval_evaluate_img(
            _ptr(d_boxes), _ptr(d_area), D, _ptr(g_boxes), _ptr(g_crowd),
            _ptr(g_ignore), _ptr(g_area), G, _ptr(iou_thrs), T,
            _ptr(area_rng), A, _ptr(dtm), _ptr(dt_ig), _ptr(g_ig), _ptr(npig))

        result = {"dtScores": scores, "num_dt": D, "num_gt": G}
        for a in range(A):
            result[a] = {
                "dtMatches": dtm[a], "dtIgnore": dt_ig[a].astype(bool),
                "gtIgnore": g_ig[a].astype(bool),
                "num_nonignored_gt": int(npig[a]),
            }
        return result

    def accumulate(self):
        lib = load_library()
        p = self.params
        T, R = len(p.iouThrs), len(p.recThrs)
        K, A, M = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores_out = -np.ones((T, R, K, A, M))
        rec_thrs = _cp(p.recThrs, np.float64)

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
                    ds = _cp(dt_scores[order], np.float64)
                    dtm = _cp(np.concatenate(
                        [e[a]["dtMatches"][:, :maxDet] for e in per_img],
                        axis=1)[:, order], np.int64)
                    dt_ig = _cp(np.concatenate(
                        [e[a]["dtIgnore"][:, :maxDet] for e in per_img],
                        axis=1)[:, order], np.uint8)
                    npig = sum(e[a]["num_nonignored_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    N = ds.shape[0]
                    prec = np.zeros((T, R), np.float64)
                    sc = np.zeros((T, R), np.float64)
                    rec = np.zeros((T,), np.float64)
                    lib.cocoeval_accumulate_cell(
                        _ptr(dtm), _ptr(dt_ig), _ptr(ds), T, N, npig,
                        _ptr(rec_thrs), R, _ptr(prec), _ptr(sc), _ptr(rec))
                    precision[:, :, k, a, m] = prec
                    scores_out[:, :, k, a, m] = sc
                    recall[:, k, a, m] = rec
        self.eval = {"params": p, "precision": precision,
                     "recall": recall, "scores": scores_out}
