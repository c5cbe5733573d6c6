"""The port's copy of tscd_tpu/postprocess/motion_eval.py (numpy; no JAX).

ImageNet VID motion-speed mAP breakdown — exact port of the
FGFA-derived protocol (reference: tools/imagenet_vid_eval_motion.py,
MOTION_RANGES :22, vid_eval_motion :113, calculate_ap :344,
parse_ap_data in tools/motion_utils.py:183).

Protocol details reproduced 1:1 (tests/test_motion_eval_parity.py runs
the reference implementation on the same synthetic data):
- +1 pixel box convention in every IoU (parse_vid_rec :78-81, :222-227)
- per-GT adaptive match threshold min(area/((w+10)(h+10)), 0.5)
- greedy confidence-ordered matching per image, class-checked for the
  match but class-blind for the ignore overlaps (:283-290)
- detections matched to motion/area-IGNORED GTs count neither tp nor fp
- unmatched detections get FRACTIONAL fp: 1 if the nearest GT is
  in-range, 0 if the nearest is ignored, the image's ignored-GT fraction
  on ties, and the dataset-wide in-range fraction on empty images
  (:296-310)
- per-class npos excludes ignored GTs; classes with npos<=0 are dropped
  from the mean (parse_ap_data)

Detections and GT are in-memory per-frame arrays; the per-GT motion IoU
(average IoU of a GT box with itself +-10 frames) either comes from the
official `imagenet_vid_groundtruth_motion_iou.mat` (`load_motion_mat`)
or is recomputed from GT tracks (`compute_motion_ious`).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# [total, fast, medium, slow] (reference :22 + motion_utils.py:183)
MOTION_RANGES = [[0.0, 1.0], [0.0, 0.7], [0.7, 0.9], [0.9, 1.0]]
MOTION_NAMES = ["total", "fast", "medium", "slow"]
AREA_RANGES = [[0, 1e5 * 1e5]]


def box_iou(b1: np.ndarray, b2: np.ndarray) -> float:
    """+1 convention IoU (reference boxoverlap :330)."""
    iw = min(b1[2], b2[2]) - max(b1[0], b2[0]) + 1
    ih = min(b1[3], b2[3]) - max(b1[1], b2[1]) + 1
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    ua = ((b1[2] - b1[0] + 1.0) * (b1[3] - b1[1] + 1.0)
          + (b2[2] - b2[0] + 1.0) * (b2[3] - b2[1] + 1.0) - inter)
    return float(inter / ua)


def compute_motion_ious(gt_tracks: Dict[int, List[Tuple[int, np.ndarray]]],
                        window: int = 10) -> Dict[Tuple[int, int], float]:
    """track_id -> [(frame, xyxy box)] -> {(frame, track_id): motion iou}
    (mean IoU of the box with the same track's boxes +-window frames —
    the FGFA metric the official .mat file precomputes)."""
    out = {}
    for tid, tr in gt_tracks.items():
        frames = {f: b for f, b in tr}
        for f, b in tr:
            ious = []
            for df in range(-window, window + 1):
                if df == 0 or (f + df) not in frames:
                    continue
                ious.append(box_iou(b, frames[f + df]))
            out[(f, tid)] = float(np.mean(ious)) if ious else 1.0
    return out


def load_motion_mat(path: str) -> List[np.ndarray]:
    """Load the official imagenet_vid_groundtruth_motion_iou.mat into a
    per-image list of per-GT motion IoUs (reference :232-236: empty
    cells become 0)."""
    import scipy.io as sio
    m = sio.loadmat(path)["motion_iou"]
    out = []
    for i in range(len(m)):
        row = m[i][0]
        out.append(np.array([row[j][0] if len(row[j]) != 0 else 0
                             for j in range(len(row))], np.float64).ravel())
    return out


def vid_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC all-points interpolated AP (reference vid_ap :90)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def vid_eval_motion(dets_per_frame: List[np.ndarray],
                    gts_per_frame: List[np.ndarray],
                    gt_motion_iou: Optional[List[np.ndarray]] = None,
                    num_classes: int = 30,
                    motion_ranges: Sequence[Sequence[float]] = None,
                    area_ranges: Sequence[Sequence[float]] = None,
                    default_iou_thr: float = 0.5,
                    pixel_tolerance: int = 10) -> Dict[str, float]:
    """Exact port of the reference vid_eval_motion (:113-327).

    dets_per_frame[f]: (K, 7) [x1,y1,x2,y2,obj,score,cls]
      (confidence = obj*score, matching the imdb dump convention);
    gts_per_frame[f]: (N, 5) [x1,y1,x2,y2,cls];
    gt_motion_iou[f]: (N,) per-GT motion iou (None -> all 1.0 = slow).
    Returns {"mAP_total","mAP_fast","mAP_medium","mAP_slow"}.
    """
    motion_ranges = motion_ranges or MOTION_RANGES
    area_ranges = area_ranges or AREA_RANGES
    n_imgs = len(gts_per_frame)
    if gt_motion_iou is None:
        gt_motion_iou = [np.ones(len(g)) for g in gts_per_frame]

    # per-image conf-sorted detections (reference :180-191)
    det_labels, det_confs, det_boxes = [], [], []
    for f in range(n_imgs):
        d = np.asarray(dets_per_frame[f], np.float64).reshape(-1, 7)
        conf = d[:, 4] * d[:, 5]
        order = np.argsort(-conf)
        det_labels.append(d[order, 6].astype(int))
        det_confs.append(conf[order])
        det_boxes.append(d[order, :4])

    # per-GT adaptive thresholds + class counts (parse_vid_rec :78-83)
    gt_thr, npos0 = [], np.zeros(num_classes)
    for g in gts_per_frame:
        g = np.asarray(g, np.float64).reshape(-1, 5)
        w = g[:, 2] - g[:, 0] + 1
        h = g[:, 3] - g[:, 1] + 1
        thr = (w * h) / ((w + pixel_tolerance) * (h + pixel_tolerance))
        gt_thr.append(np.minimum(thr, default_iou_thr))
        for c in g[:, 4].astype(int):
            npos0[c] += 1

    # overlap table (reference :195-229)
    ov_all = []
    for f in range(n_imgs):
        g = np.asarray(gts_per_frame[f], np.float64).reshape(-1, 5)
        ov_all.append([np.array([box_iou(bb, g[k, :4])
                                 for k in range(len(g))])
                       for bb in det_boxes[f]])

    all_motion = (np.concatenate([np.asarray(m, np.float64).ravel()
                                  for m in gt_motion_iou])
                  if any(len(m) for m in gt_motion_iou)
                  else np.zeros(0))

    results = {}
    for rng, name in zip(motion_ranges, MOTION_NAMES):
        for area_range in area_ranges:
            npos = npos0.copy()
            empty_weight = (float(np.mean((all_motion >= rng[0])
                                          & (all_motion <= rng[1])))
                            if len(all_motion) else 0.0)
            tp_cell, fp_cell = [], []
            for f in range(n_imgs):
                g = np.asarray(gts_per_frame[f], np.float64).reshape(-1, 5)
                n_gt = len(g)
                miou = np.asarray(gt_motion_iou[f], np.float64).ravel()
                ig_motion = (miou < rng[0]) | (miou > rng[1])
                area = (g[:, 3] - g[:, 1] + 1) * (g[:, 2] - g[:, 0] + 1)
                ig_area = (area < area_range[0]) | (area > area_range[1])
                detected = np.zeros(n_gt, bool)

                n_det = len(det_labels[f])
                tp = np.zeros(n_det)
                fp = np.zeros(n_det)
                for j in range(n_det):
                    ov = ov_all[f][j]
                    ovmax, kmax = -1.0, -1
                    ovmax_ig, ovmax_nig = -1.0, -1.0
                    for k in range(n_gt):
                        if (ov[k] >= gt_thr[f][k] and ov[k] > ovmax
                                and not detected[k]
                                and det_labels[f][j] == int(g[k, 4])):
                            ovmax, kmax = ov[k], k
                        if ig_motion[k] and ov[k] > ovmax_ig:
                            ovmax_ig = ov[k]
                        if not ig_motion[k] and ov[k] > ovmax_nig:
                            ovmax_nig = ov[k]
                    if kmax >= 0:
                        detected[kmax] = True
                        if not ig_motion[kmax] and not ig_area[kmax]:
                            tp[j] = 1.0
                    else:
                        bb = det_boxes[f][j]
                        bb_area = ((bb[3] - bb[1] + 1)
                                   * (bb[2] - bb[0] + 1))
                        if bb_area < area_range[0] or bb_area > area_range[1]:
                            continue
                        if ovmax_nig > ovmax_ig:
                            fp[j] = 1.0
                        elif ovmax_ig > ovmax_nig:
                            fp[j] = 0.0
                        elif n_gt == 0:
                            fp[j] = empty_weight
                        else:
                            fp[j] = float(np.sum(ig_motion)) / n_gt
                tp_cell.append(tp)
                fp_cell.append(fp)

                for k in range(n_gt):
                    if ig_motion[k] or ig_area[k]:
                        npos[int(g[k, 4])] -= 1

            # calculate_ap (:344): global confidence sort per class
            tp_all = np.concatenate(tp_cell) if tp_cell else np.zeros(0)
            fp_all = np.concatenate(fp_cell) if fp_cell else np.zeros(0)
            labels = (np.concatenate(det_labels) if det_labels
                      else np.zeros(0, int))
            confs = (np.concatenate(det_confs) if det_confs
                     else np.zeros(0))
            order = np.argsort(-confs)
            tp_all, fp_all, labels = tp_all[order], fp_all[order], \
                labels[order]
            aps = np.full(num_classes, -1.0)
            for c in range(num_classes):
                if npos[c] <= 0:
                    continue
                tpc = np.cumsum(tp_all[labels == c])
                fpc = np.cumsum(fp_all[labels == c])
                rec = tpc / npos[c]
                prec = tpc / np.maximum(tpc + fpc,
                                        np.finfo(np.float64).eps)
                aps[c] = vid_ap(rec, prec)
            valid = aps[aps >= 0]
            results[f"mAP_{name}"] = (float(np.mean(valid)) if len(valid)
                                      else 0.0)
    return results
