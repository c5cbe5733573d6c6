"""SimOTA label assignment (counterpart of tscd_tpu/ops/simota.py;
reference yolox/models/yolo_head.py:442-659), fixed-shape and batched
over images: the JAX package vmaps one image's assignment, here the
image is a leading axis written out.

  - candidate anchors: centre inside any gt box or within 2.5 strides of
    a gt centre (get_in_boxes_info:540);
  - cost = class BCE(sqrt(cls_prob * obj_prob), one-hot) + 3 (-log(iou +
    1e-8)) + 1e5 (candidate but not in both box and centre), with the
    class BCE summed without the (G, A, C) tensor, as in JAX;
  - dynamic k per gt: the int() truncation of its top-10 IoU sum, at
    least 1;
  - each gt takes its dynamic k lowest-cost candidate anchors; an anchor
    claimed by several keeps the gt of least cost over all gts.

Ties break to the lower index, as `lax.top_k`, `argmin` and `argmax` do:
the top k is a stable sort, torch's argmin/argmax return the first
extreme. Logs are clamped at -100, as torch's BCE (and `_safe_log`).
The targets carry no gradient.
"""

from typing import NamedTuple, Tuple

import torch

from .boxes import bboxes_iou
from .nms import top_k

BIG = 1e9
CENTER_RADIUS = 2.5
_EPS = 1e-12
_LOG_CLAMP = -100.0


class SimOTATargets(NamedTuple):
    cls_target: torch.Tensor   # (B, A, C) IoU-weighted one-hot, 0 off fg
    reg_target: torch.Tensor   # (B, A, 4) matched gt box (cxcywh)
    l1_target: torch.Tensor    # (B, A, 4) encoded offsets in grid units
    obj_target: torch.Tensor   # (B, A) 0/1
    fg_mask: torch.Tensor      # (B, A) bool
    matched_gt: torch.Tensor   # (B, A) index into the gt slots
    num_fg: torch.Tensor       # (B,) float
    num_gt: torch.Tensor       # (B,) float


def labels_to_padded(labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, G, 5) [cls, cx, cy, w, h] zero-padded -> (boxes, classes,
    valid); a row is a gt where its sum is positive (yolo_head.py:283)."""
    return labels[..., 1:5], labels[..., 0].to(torch.int32), labels.sum(-1) > 0


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.clamp(min=_EPS)).clamp(min=_LOG_CLAMP)


def in_boxes_info(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  x_shifts: torch.Tensor, y_shifts: torch.Tensor,
                  strides: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, G, 4 cxcywh), (B, G), (A,) x 3 -> (fg_candidate (B, A), in_box
    (B, G, A), in_center (B, G, A)), as get_in_boxes_info."""
    xc = (x_shifts + 0.5) * strides
    yc = (y_shifts + 0.5) * strides
    gx, gy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]
    in_box = ((xc > gx - gw / 2) & (xc < gx + gw / 2)
              & (yc > gy - gh / 2) & (yc < gy + gh / 2))
    r = CENTER_RADIUS * strides
    in_center = ((xc > gx - r) & (xc < gx + r)
                 & (yc > gy - r) & (yc < gy + r))
    in_box = in_box & gt_valid[..., None]
    in_center = in_center & gt_valid[..., None]
    return in_box.any(1) | in_center.any(1), in_box, in_center


@torch.no_grad()
def simota_assign(bbox_preds: torch.Tensor, obj_logits: torch.Tensor,
                  cls_logits: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                  x_shifts: torch.Tensor, y_shifts: torch.Tensor,
                  strides: torch.Tensor) -> SimOTATargets:
    """bbox_preds (B, A, 4) cxcywh pixels; obj_logits (B, A); cls_logits
    (B, A, C); gt_* padded to G slots with the gt_valid mask; shifts and
    strides (A,)."""
    B, A, C = cls_logits.shape
    G = gt_boxes.shape[1]
    dev = cls_logits.device
    f32 = torch.float32

    fg_cand, in_box, in_center = in_boxes_info(gt_boxes, gt_valid, x_shifts,
                                               y_shifts, strides)
    both = in_box & in_center

    ious = bboxes_iou(gt_boxes, bbox_preds, xyxy=False)          # (B, G, A)
    ious = torch.where(gt_valid[..., None] & fg_cand[:, None], ious, 0.0)
    iou_cost = -torch.log(ious + 1e-8)

    # class BCE without the (G, A, C) tensor (tscd_tpu/ops/simota.py:15-20)
    q = torch.sqrt(torch.sigmoid(cls_logits.to(f32))
                   * torch.sigmoid(obj_logits.to(f32))[..., None])
    log_q, log_1mq = _safe_log(q), _safe_log(1.0 - q)
    s_all = (-log_1mq).sum(-1)                                   # (B, A)
    at = gt_classes.long().clamp(0, C - 1)[:, None, :].expand(B, A, G)
    log_q_at = log_q.gather(2, at).transpose(1, 2)               # (B, G, A)
    log_1mq_at = log_1mq.gather(2, at).transpose(1, 2)
    cls_cost = s_all[:, None] + log_1mq_at - log_q_at

    cost = (cls_cost + 3.0 * iou_cost
            + 1e5 * (~both).to(f32)
            + BIG * (~fg_cand)[:, None].to(f32)
            + BIG * (~gt_valid)[..., None].to(f32))

    k = min(10, A)
    dynamic_ks = top_k(ious, k)[0].sum(-1).to(torch.int32).clamp(min=1)
    dynamic_ks = torch.where(gt_valid, dynamic_ks, 0)            # (B, G)

    # each gt's dynamic k lowest costs, among its candidates only (the
    # reference's cost matrix has candidate columns alone)
    topk_idx = top_k(-cost, k)[1]                                # (B, G, k)
    rank = torch.arange(k, device=dev)
    cand_at = fg_cand.gather(1, topk_idx.reshape(B, G * k)).reshape(B, G, k)
    rank_ok = (rank < dynamic_ks[..., None]) & cand_at
    matching = torch.zeros(B, G, A, dtype=torch.bool, device=dev)
    matching = matching.scatter(2, topk_idx, rank_ok)

    # an anchor claimed by several gts keeps the least-cost gt over all
    conflict = matching.sum(1) > 1                               # (B, A)
    best_gt = cost.argmin(1)
    reassigned = torch.arange(G, device=dev)[None, :, None] == best_gt[:, None]
    matching = torch.where(conflict[:, None], reassigned, matching)

    fg_mask = matching.any(1)                                    # (B, A)
    matched_gt = matching.to(torch.uint8).argmax(1)
    pred_ious = (matching * ious).sum(1)
    cls_of = gt_classes.long().gather(1, matched_gt)
    one_hot = (cls_of[..., None] == torch.arange(C, device=dev)).to(f32)
    cls_target = one_hot * pred_ious[..., None] * fg_mask[..., None]
    reg_target = gt_boxes.gather(1, matched_gt[..., None].expand(B, A, 4))
    # l1 target in grid units (get_l1_target, yolo_head.py:435)
    l1_target = torch.stack([
        reg_target[..., 0] / strides - x_shifts,
        reg_target[..., 1] / strides - y_shifts,
        torch.log(reg_target[..., 2] / strides + 1e-8),
        torch.log(reg_target[..., 3] / strides + 1e-8)], -1)
    return SimOTATargets(cls_target, reg_target, l1_target, fg_mask.to(f32),
                         fg_mask, matched_gt, fg_mask.to(f32).sum(-1),
                         gt_valid.to(f32).sum(-1))
