"""YOLOX, TSCD stage-2 and YOLOV losses (counterpart of
tscd_tpu/train/losses.py: yolox_loss, tscd_loss and yolov_loss; reference
yolo_head.py:267-433, tscd_head.py:1008, yolovp_msa.py get_losses and
v_plus_head.py's ota_mode path).

A pure function of the head's outputs and the padded labels: SimOTA
assigns targets (no gradient), then the base detector's IoU, objectness
and class losses over all frames, and the refined class, matched
objectness and matched offset losses over the local frames. Each sum is
divided by its foreground count, clamped at 1.
"""

from typing import Any, Dict, Sequence

import torch

from ..models.tscd_head import encode_reg_targets
from ..ops.boxes import box_cxcywh_to_xyxy, iou_loss_cxcywh, pairwise_iou_xyxy
from ..ops.decode import anchor_centers, decode_outputs
from ..ops.simota import labels_to_padded, simota_assign

REG_WEIGHT = 3.0          # base IoU loss
IOU_MATCH_WEIGHT = 6.0    # matched offsets (smooth L1)
MATCHED_OBJ_CLIP = 15.0   # tscd_head.py:1185-1186


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, in JAX's stable form."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, A, ...) at idx (B, P) -> (B, P, ...)."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def iou_based_refined_targets(prop_boxes: torch.Tensor, prop_valid: torch.Tensor,
                              ota_reg_target: torch.Tensor,
                              ota_cls_target: torch.Tensor,
                              ota_fg_mask: torch.Tensor, fg_iou: float = 0.6,
                              bg_iou: float = 0.3):
    """The ota_mode=False refined labels (get_iou_based_label,
    tscd_head.py:1853), batched over frames: each proposal (L, P, 4 xyxy)
    against the matched gt boxes of its frame's SimOTA fg anchors; fg at
    IoU >= fg_iou, ignored between bg_iou and fg_iou, the class from the
    first maximal anchor. Returns (fg, ignore, cls_target, reg_target)."""
    iou = pairwise_iou_xyxy(prop_boxes, box_cxcywh_to_xyxy(ota_reg_target))
    iou = torch.where(ota_fg_mask[:, None, :], iou, 0.0)          # (L, P, A)
    best_iou = iou.amax(-1)
    best_a = iou.argmax(-1)                  # the first maximum, as JAX
    fg = (best_iou >= fg_iou) & prop_valid
    ignore = (best_iou >= bg_iou) & ~fg
    cls_target = ((_rows(ota_cls_target, best_a) > 0).to(torch.float32)
                  * best_iou[..., None] * fg[..., None])
    return fg, ignore, cls_target, _rows(ota_reg_target, best_a)


def tscd_loss(head_out: Dict[str, Any], labels: torch.Tensor,
              strides: Sequence[int], lframe: int,
              ota_mode: bool = True) -> Dict[str, torch.Tensor]:
    """total = 3 iou + obj + cls (base detector, all frames)
             + refined cls + matched obj (clipped at 15) + 6 matched
               smooth L1 (local frames; 0 without the matcher's outputs),
    normalised by the SimOTA fg count (base) and the local one (refined);
    with ota_mode=False the refined targets are IoU-based
    (`iou_based_refined_targets`). Returns each term, the total and
    `num_fg` (fg anchors a gt), as the JAX dict."""
    f32 = torch.float32
    raw = head_out["raw_outputs"].to(f32)                      # (F, A, 5+C)
    hw = head_out["hw"]
    props = head_out["proposals"]

    decoded = decode_outputs(raw, hw, strides)
    bbox_preds = decoded[..., :4]
    obj_logits = raw[..., 4]
    cls_logits = raw[..., 5:]

    if "simota" in head_out:
        # a cat_ota_fg head ran SimOTA in its forward: reuse it (losses.py:114-118)
        tgt = head_out["simota"]
    else:
        gt_boxes, gt_classes, gt_valid = labels_to_padded(labels.to(f32))
        tgt = simota_assign(bbox_preds, obj_logits, cls_logits, gt_boxes,
                            gt_classes, gt_valid, *anchor_centers(hw, strides, raw.device))

    num_fg = tgt.num_fg.sum().clamp(min=1.0)
    fg = tgt.fg_mask.to(f32)
    loss_iou = (iou_loss_cxcywh(bbox_preds, tgt.reg_target) * fg).sum() / num_fg
    loss_obj = bce_with_logits(obj_logits, tgt.obj_target).sum() / num_fg
    loss_cls = (bce_with_logits(cls_logits, tgt.cls_target).sum(-1) * fg).sum() / num_fg

    # refined targets at the local frames' proposal anchors
    l_idx = props.idx[:lframe]                                 # (L, P)
    l_valid = props.valid[:lframe]
    slot_valid = l_valid.to(f32)
    if ota_mode:
        refined_fg = _rows(tgt.fg_mask[:lframe], l_idx) & l_valid
        refined_cls_t = _rows(tgt.cls_target[:lframe], l_idx)
        refined_reg_t = _rows(tgt.reg_target[:lframe], l_idx)
        obj_weight = slot_valid
        num_fg_local = tgt.num_fg[:lframe].sum().clamp(min=1.0)
    else:
        refined_fg, ignore, refined_cls_t, refined_reg_t = iou_based_refined_targets(
            props.boxes[:lframe], l_valid, tgt.reg_target[:lframe],
            tgt.cls_target[:lframe], tgt.fg_mask[:lframe])
        obj_weight = slot_valid * (1.0 - ignore.to(f32))
        num_fg_local = refined_fg.to(f32).sum().clamp(min=1.0)
    refined_fg_f = refined_fg.to(f32)

    loss_refined_cls = (bce_with_logits(
        head_out["refined_cls_logits"][:lframe].to(f32), refined_cls_t
    ).sum(-1) * refined_fg_f).sum() / num_fg_local
    if "matcher_obj_logits" in head_out:
        loss_matched_obj = (bce_with_logits(
            head_out["matcher_obj_logits"].to(f32), refined_fg_f
        ) * obj_weight).sum() / num_fg_local
        # the reference's `loss / float(loss) * 15`: the value becomes 15
        # and the gradient keeps its direction, scaled by 15 / loss
        loss_matched_obj = torch.where(
            loss_matched_obj > MATCHED_OBJ_CLIP,
            loss_matched_obj * (MATCHED_OBJ_CLIP / loss_matched_obj).detach(),
            loss_matched_obj)
        enc_t = encode_reg_targets(refined_reg_t, props.boxes[:lframe]).detach()
        loss_matched_iou = (smooth_l1(
            head_out["matcher_reg_offsets"].to(f32) - enc_t
        ).sum(-1) * refined_fg_f).sum() / num_fg_local
    else:
        # no matcher outputs (decouple_reg or reconf off): no matched terms
        loss_matched_obj = loss_matched_iou = torch.zeros((), device=raw.device)

    total = (REG_WEIGHT * loss_iou + loss_obj + loss_cls + loss_refined_cls
             + loss_matched_obj + IOU_MATCH_WEIGHT * loss_matched_iou)
    return {
        "total_loss": total,
        "iou_loss": REG_WEIGHT * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "loss_refined_cls": loss_refined_cls,
        "loss_matched_obj": loss_matched_obj,
        "loss_matched_iou": IOU_MATCH_WEIGHT * loss_matched_iou,
        "num_fg": tgt.num_fg.sum() / tgt.num_gt.sum().clamp(min=1.0),
    }


def yolov_loss(head_out: Dict[str, Any], labels: torch.Tensor,
               strides: Sequence[int], num_refined_frames: int) -> Dict[str, torch.Tensor]:
    """YOLOV / YOLOV++ losses (losses.py:206-268): total = 3 iou + obj +
    cls (the base detector on every frame) + refined cls + refined obj
    (with the head's obj logits) at the proposal anchors of the first
    `num_refined_frames` frames, the refined targets from the same SimOTA
    assignment (fg where the anchor is SimOTA's fg and the slot valid; the
    obj BCE over every valid slot), the refined terms normalised by those
    frames' fg count."""
    f32 = torch.float32
    raw = head_out["raw_outputs"].to(f32)
    hw = head_out["hw"]
    props = head_out["proposals"]
    decoded = decode_outputs(raw, hw, strides)
    bbox_preds = decoded[..., :4]
    obj_logits = raw[..., 4]
    cls_logits = raw[..., 5:]
    gt_boxes, gt_classes, gt_valid = labels_to_padded(labels.to(f32))
    tgt = simota_assign(bbox_preds, obj_logits, cls_logits, gt_boxes, gt_classes, gt_valid,
                        *anchor_centers(hw, strides, raw.device))
    num_fg = tgt.num_fg.sum().clamp(min=1.0)
    fg = tgt.fg_mask.to(f32)
    loss_iou = (iou_loss_cxcywh(bbox_preds, tgt.reg_target) * fg).sum() / num_fg
    loss_obj = bce_with_logits(obj_logits, tgt.obj_target).sum() / num_fg
    loss_cls = (bce_with_logits(cls_logits, tgt.cls_target).sum(-1) * fg).sum() / num_fg

    R = num_refined_frames
    num_fg_r = tgt.num_fg[:R].sum().clamp(min=1.0)
    r_idx, r_valid = props.idx[:R], props.valid[:R]
    refined_fg = (_rows(tgt.fg_mask[:R], r_idx) & r_valid).to(f32)
    loss_refined_cls = (bce_with_logits(
        head_out["refined_cls_logits"][:R].to(f32), _rows(tgt.cls_target[:R], r_idx)
    ).sum(-1) * refined_fg).sum() / num_fg_r
    if "refined_obj_logits" in head_out:
        loss_refined_obj = (bce_with_logits(
            head_out["refined_obj_logits"][:R].to(f32), refined_fg
        ) * r_valid.to(f32)).sum() / num_fg_r
    else:
        loss_refined_obj = torch.zeros((), device=raw.device)
    total = (REG_WEIGHT * loss_iou + loss_obj + loss_cls + loss_refined_cls
             + loss_refined_obj)
    return {
        "total_loss": total,
        "iou_loss": REG_WEIGHT * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "loss_refined_cls": loss_refined_cls,
        "loss_refined_obj": loss_refined_obj,
        "num_fg": tgt.num_fg.sum() / tgt.num_gt.sum().clamp(min=1.0),
    }


YOLOX_REG_WEIGHT = 5.0


def yolox_loss(raw_outputs: torch.Tensor, labels: torch.Tensor,
               hw: Sequence, strides: Sequence[int],
               use_l1: bool = False) -> Dict[str, torch.Tensor]:
    """Still-image YOLOX loss (losses.py:yolox_loss): total = 5 iou + obj +
    cls (+ l1 on the raw reg outputs in grid units with `use_l1`), each
    summed over the batch and divided by its SimOTA fg count, clamped at 1.
    raw_outputs (B, A, 5 + C); labels (B, G, 5) [cls, cx, cy, w, h] padded
    with zero rows."""
    f32 = torch.float32
    raw = raw_outputs.to(f32)
    decoded = decode_outputs(raw, hw, strides)
    bbox_preds = decoded[..., :4]
    obj_logits = raw[..., 4]
    cls_logits = raw[..., 5:]
    gt_boxes, gt_classes, gt_valid = labels_to_padded(labels.to(f32))
    tgt = simota_assign(bbox_preds, obj_logits, cls_logits, gt_boxes, gt_classes,
                        gt_valid, *anchor_centers(hw, strides, raw.device))
    num_fg = tgt.num_fg.sum().clamp(min=1.0)
    fg = tgt.fg_mask.to(f32)
    loss_iou = (iou_loss_cxcywh(bbox_preds, tgt.reg_target) * fg).sum() / num_fg
    loss_obj = bce_with_logits(obj_logits, tgt.obj_target).sum() / num_fg
    loss_cls = (bce_with_logits(cls_logits, tgt.cls_target).sum(-1) * fg).sum() / num_fg
    if use_l1:
        loss_l1 = ((raw[..., :4] - tgt.l1_target).abs().sum(-1) * fg).sum() / num_fg
    else:
        loss_l1 = torch.zeros((), device=raw.device)
    return {
        "total_loss": YOLOX_REG_WEIGHT * loss_iou + loss_obj + loss_cls + loss_l1,
        "iou_loss": YOLOX_REG_WEIGHT * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "l1_loss": loss_l1,
        "num_fg": tgt.num_fg.sum() / tgt.num_gt.sum().clamp(min=1.0),
    }
