"""The port's copy of tscd_tpu/postprocess/linking.py (numpy; no JAX).

Trajectory (tubelet) linking for traj_linking eval mode and the online
memory bank (reference: yolox/models/post_process.py:186,251,305,321).

Host-side numpy: these run between streaming windows on small proposal
sets (<= a few hundred rows), not in the jitted graph.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

MAX_LINKING_FRAMES = 400  # chunk bound (reference post_process.py:325-332)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4),(M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2]) -
                 np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3]) -
                 np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    bb = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + bb[None] - inter, 1e-12)


def get_linking_mat(dets1: np.ndarray, dets2: np.ndarray,
                    iou_thresh: float = 0.5) -> np.ndarray:
    """Linkability between consecutive-frame detections: same class AND
    IoU above threshold (reference get_linking_mat, post_process.py:305).
    dets are (K, 7) rows [x1,y1,x2,y2,obj,score,cls]."""
    iou = iou_matrix(dets1[:, :4], dets2[:, :4])
    same_cls = dets1[:, 6:7] == dets2[None, :, 6]
    return (iou > iou_thresh) & same_cls


def get_tubelets(frame_dets: Sequence[np.ndarray],
                 iou_thresh: float = 0.5) -> List[List[tuple]]:
    """Greedy tubelet construction over per-frame (K, 7) dets
    (reference get_tubelets, post_process.py:251): extend each track with
    the highest-score linkable detection in the next frame."""
    tubes: List[List[tuple]] = []
    used = [np.zeros(len(d), bool) for d in frame_dets]
    for f0 in range(len(frame_dets)):
        for i0 in range(len(frame_dets[f0])):
            if used[f0][i0]:
                continue
            tube = [(f0, i0)]
            used[f0][i0] = True
            f, i = f0, i0
            while f + 1 < len(frame_dets) and len(frame_dets[f + 1]):
                link = get_linking_mat(frame_dets[f][i:i + 1],
                                       frame_dets[f + 1], iou_thresh)[0]
                link = link & ~used[f + 1]
                if not link.any():
                    break
                cand = np.where(link)[0]
                scores = (frame_dets[f + 1][cand, 4]
                          * frame_dets[f + 1][cand, 5])
                j = int(cand[np.argmax(scores)])
                tube.append((f + 1, j))
                used[f + 1][j] = True
                f, i = f + 1, j
            tubes.append(tube)
    return tubes


def post_linking(frame_dets: Sequence[np.ndarray],
                 iou_thresh: float = 0.5) -> List[np.ndarray]:
    """Tubelet-averaged rescoring (reference post_linking,
    post_process.py:321): within each tubelet, every detection's
    obj*score is replaced by the tubelet mean. Videos longer than
    MAX_LINKING_FRAMES are processed in chunks (:325-332)."""
    out = [d.copy() for d in frame_dets]
    for lo in range(0, len(out), MAX_LINKING_FRAMES):
        chunk = out[lo:lo + MAX_LINKING_FRAMES]
        for tube in get_tubelets(chunk, iou_thresh):
            mean_score = float(np.mean(
                [chunk[f][i, 4] * chunk[f][i, 5] for f, i in tube]))
            for f, i in tube:
                chunk[f][i, 4] = 1.0
                chunk[f][i, 5] = mean_score
    return out


def online_previous_selection(bank: Dict[str, list], frame_num: int = 31,
                              local_bank_size: Optional[int] = None,
                              rng: Optional[np.random.Generator] = None
                              ) -> Dict[str, np.ndarray]:
    """Rolling feature-bank maintenance for streaming inference
    (reference online_previous_selection, post_process.py:186 +
    tools/yolov_demo_online.py:214-234): keep the most recent
    `frame_num` frames' features; when over budget, evict a random older
    frame. `bank` maps key -> list of per-frame arrays
    (cls_features / reg_features / scores / boxes...)."""
    rng = rng or np.random.default_rng()
    lengths = {k: len(v) for k, v in bank.items()}
    n = max(lengths.values()) if lengths else 0
    while n > frame_num:
        evict = int(rng.integers(0, n - 1))  # never the newest frame
        for v in bank.values():
            if len(v) > evict:
                v.pop(evict)
        n -= 1
    return {k: (np.concatenate(v, axis=0) if len(v) else np.zeros((0,)))
            for k, v in bank.items()}
