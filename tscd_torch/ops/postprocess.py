"""Fixed-shape detection postprocess (counterpart of
tscd_tpu/ops/postprocess.py), batched over a leading frame axis.

Detection row convention: (x1, y1, x2, y2, obj, score, cls).
`postprocess_dense` is the still-image detector's (YOLOX);
`select_proposals` the reference's postpro_woclass.
"""

from typing import NamedTuple

import torch

from .boxes import box_cxcywh_to_xyxy
from .nms import batched_class_aware_nms, top_k


class Detections(NamedTuple):
    boxes: torch.Tensor   # (L, K, 4) xyxy
    obj: torch.Tensor     # (L, K)
    score: torch.Tensor   # (L, K) class prob (NMS key = obj*score)
    cls_id: torch.Tensor  # (L, K) int
    mask: torch.Tensor    # (L, K) bool


class Proposals(NamedTuple):
    boxes: torch.Tensor       # (B, P, 4) xyxy pixels
    obj: torch.Tensor         # (B, P) objectness (sigmoided)
    cls_conf: torch.Tensor    # (B, P) best class prob
    cls_id: torch.Tensor      # (B, P) int
    cls_scores: torch.Tensor  # (B, P, C) all class probs
    idx: torch.Tensor         # (B, P) source anchor index
    mask: torch.Tensor        # (B, P) bool validity


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    return torch.gather(x, 1, idx)


def postprocess_refined(boxes: torch.Tensor, obj: torch.Tensor,
                        cls_scores: torch.Tensor, valid: torch.Tensor,
                        conf_thre: float = 0.001, nms_thre: float = 0.5,
                        out_k: int = 100) -> Detections:
    """Per frame, over P proposals with (P, C) refined class
    probabilities (reference post_process.py:9): every (proposal, class)
    pair with prob >= conf_thre and obj*prob >= conf_thre enters
    class-aware NMS with key obj*prob. boxes (L, P, 4), obj (L, P),
    cls_scores (L, P, C), valid (L, P)."""
    L, P, C = cls_scores.shape
    pair_boxes = boxes.repeat_interleave(C, dim=1)            # (L, P*C, 4)
    pair_obj = obj.repeat_interleave(C, dim=1)
    pair_cls = torch.arange(C, device=boxes.device).repeat(P).expand(L, -1)
    pair_score = cls_scores.reshape(L, P * C)
    pair_valid = (valid.repeat_interleave(C, dim=1)
                  & (pair_score >= conf_thre)
                  & (pair_obj * pair_score >= conf_thre))
    nms_key = pair_obj * pair_score
    keep = batched_class_aware_nms(pair_boxes, nms_key, pair_cls, pair_valid,
                                   nms_thre)
    surv = torch.where(keep, nms_key, torch.full_like(nms_key, -float("inf")))
    out_scores, pick = top_k(surv, min(out_k, P * C))
    return Detections(_take(pair_boxes, pick), _take(pair_obj, pick),
                      _take(pair_score, pick), _take(pair_cls, pick),
                      out_scores > -float("inf"))


def postprocess_best_class(boxes: torch.Tensor, obj: torch.Tensor,
                           cls_conf: torch.Tensor, cls_id: torch.Tensor,
                           valid: torch.Tensor, conf_thre: float = 0.001,
                           nms_thre: float = 0.5,
                           out_k: int = 100) -> Detections:
    """Per frame, each proposal's best class only (the reference's
    `result_ori` branch, post_process.py:69-81)."""
    P = boxes.shape[1]
    key = obj * cls_conf
    ok = valid & (key >= conf_thre)
    keep = batched_class_aware_nms(boxes, key, cls_id, ok, nms_thre)
    surv = torch.where(keep, key, torch.full_like(key, -float("inf")))
    out_scores, pick = top_k(surv, min(out_k, P))
    return Detections(_take(boxes, pick), _take(obj, pick),
                      _take(cls_conf, pick), _take(cls_id, pick),
                      out_scores > -float("inf"))


DENSE_CANDIDATES = 2048     # JAX's cap on the candidates that enter NMS


def postprocess_dense(decoded: torch.Tensor, num_classes: int, conf_thre: float = 0.7,
                      nms_thre: float = 0.45, out_k: int = 100) -> Detections:
    """Still-image postprocess (tscd_tpu/ops/postprocess.py:postprocess_dense,
    yolox/utils/boxes.py:33) on decoded (B, A, 5 + C) predictions: each
    anchor's best class (the first maximum), the score obj x cls gate at
    conf_thre, the top min(2048, A) scores (ties to the lower anchor),
    class-aware NMS over them (the hand NMS kernels at (B, 2048)), then the
    top out_k survivors. Fixed shapes: mask marks the real rows."""
    boxes = box_cxcywh_to_xyxy(decoded[..., :4])
    obj = decoded[..., 4]
    cls_scores = decoded[..., 5:5 + num_classes]
    cls_conf, cls_id = cls_scores.amax(-1), cls_scores.argmax(-1)
    score = obj * cls_conf
    ninf = torch.full_like(score, -float("inf"))
    cand_scores, cand = top_k(torch.where(score >= conf_thre, score, ninf),
                              min(DENSE_CANDIDATES, score.shape[1]))
    cand_valid = cand_scores > -float("inf")
    keep = batched_class_aware_nms(_take(boxes, cand), cand_scores, _take(cls_id, cand),
                                   cand_valid, nms_thre)
    surv = torch.where(keep, cand_scores, torch.full_like(cand_scores, -float("inf")))
    out_scores, pick = top_k(surv, min(out_k, surv.shape[1]))
    src = torch.gather(cand, 1, pick)
    return Detections(_take(boxes, src), _take(obj, src), _take(cls_conf, src),
                      _take(cls_id, src), out_scores > -float("inf"))


_top_k = top_k


def select_proposals_batch(decoded: torch.Tensor, num_classes: int, nms_thre: float = 0.75,
                           top_k: int = 30, pre_topk: int = 750) -> Proposals:
    """Proposal selection per image (tscd_tpu/ops/postprocess.py:34-61,
    the reference's postpro_woclass, post_process.py:464) on decoded (B,
    A, 5 + C) predictions (cxcywh pixels, sigmoided obj and classes): the
    top `pre_topk` anchors by obj alone, class-aware NMS (the hand NMS
    kernels) scored obj x best class prob, then the first `top_k`
    survivors in that score order; fixed slots, the dead ones -inf-scored
    and masked off. Ties go to the lower index, as lax.top_k breaks them."""
    boxes = box_cxcywh_to_xyxy(decoded[..., :4])
    obj = decoded[..., 4]
    cls_scores = decoded[..., 5:5 + num_classes]
    cls_conf, cls_id = cls_scores.amax(-1), cls_scores.argmax(-1)
    top_obj, sort_idx = _top_k(obj, pre_topk)
    nms_scores = top_obj * torch.gather(cls_conf, 1, sort_idx)
    keep = batched_class_aware_nms(_take(boxes, sort_idx), nms_scores,
                                   torch.gather(cls_id, 1, sort_idx),
                                   torch.ones_like(nms_scores, dtype=torch.bool), nms_thre)
    surv = torch.where(keep, nms_scores, torch.full_like(nms_scores, -float("inf")))
    pick_scores, pick = _top_k(surv, top_k)
    src = torch.gather(sort_idx, 1, pick)
    return Proposals(_take(boxes, src), _take(obj, src), _take(cls_conf, src),
                     _take(cls_id, src), _take(cls_scores, src), src,
                     pick_scores > -float("inf"))


def select_proposals(decoded: torch.Tensor, num_classes: int, nms_thre: float = 0.75,
                     top_k: int = 30, pre_topk: int = 750) -> Proposals:
    """`select_proposals_batch` on one image's (A, 5 + C) predictions;
    each field without the batch axis."""
    out = select_proposals_batch(decoded[None], num_classes, nms_thre, top_k, pre_topk)
    return Proposals(*(t[0] for t in out))
