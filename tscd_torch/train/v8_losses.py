"""YOLOv8 (DFL head) training loss (counterpart of
tscd_tpu/train/v8_losses.py): TAL assignment (`ops.tal`), BCE on the
aligned class targets, CIoU on the boxes and Distribution Focal loss on
the bins, each weighted by the targets' scores and summed over frames
over the scores' total. Labels are the zero-padded (B, G, 5) [cls, cx,
cy, w, h] pixel rows.
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..models.yolov8 import anchor_points
from ..ops.boxes import box_cxcywh_to_xyxy, ciou_xyxy
from ..ops.simota import labels_to_padded
from ..ops.tal import tal_assign_batch


def _dfl_ce(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal cross-entropy: pred_dist (..., 4, reg_max)
    logits, target (..., 4) in [0, reg_max - 1] -> (...)."""
    tl = torch.floor(target)
    tr = tl + 1.0
    wl = tr - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, -1)
    take = lambda idx: torch.gather(  # noqa: E731
        logp, -1, idx.clamp(0, reg_max - 1).long()[..., None])[..., 0]
    return -(take(tl) * wl + take(tr) * wr).mean(-1)


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """JAX's form of the BCE with logits, term for term."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def yolov8_loss(head_out: Dict, labels: torch.Tensor, strides: Sequence[int] = (8, 16, 32),
                reg_max: int = 16, box_w: float = 7.5, cls_w: float = 0.5,
                dfl_w: float = 1.5) -> Dict[str, torch.Tensor]:
    """head_out: YOLOv8Head's {"outputs": (B, A, 4 reg_max + C), "hw"};
    labels (B, G, 5). Returns total_loss, iou_loss, cls_loss, dfl_loss and
    num_fg (foreground anchors a frame)."""
    out = head_out["outputs"].float()
    B, A, _ = out.shape
    C = out.shape[-1] - 4 * reg_max
    pred_dist = out[..., :4 * reg_max].reshape(B, A, 4, reg_max)
    cls_logits = out[..., 4 * reg_max:]

    anchor_xy, stride = anchor_points(head_out["hw"], strides, out.device)
    bins = torch.arange(reg_max, dtype=torch.float32, device=out.device)
    ltrb = torch.softmax(pred_dist, -1) @ bins                       # (B, A, 4)
    # the boxes in grid units (each anchor's stride), then in pixels
    axy_g = anchor_xy / stride[:, None]
    pred_xyxy_g = torch.cat([axy_g[None] - ltrb[..., :2], axy_g[None] + ltrb[..., 2:]], -1)
    pred_xyxy_px = pred_xyxy_g * stride[None, :, None]

    gt_boxes, gt_classes, gt_valid = labels_to_padded(labels)
    tgt = tal_assign_batch(torch.sigmoid(cls_logits), pred_xyxy_px,
                           box_cxcywh_to_xyxy(gt_boxes), gt_classes, gt_valid, anchor_xy, C)

    tss = tgt.target_scores.sum().clamp(min=1.0)
    loss_cls = _bce_logits(cls_logits, tgt.target_scores).sum() / tss

    fg = tgt.fg_mask.float()                                         # (B, A)
    weight = tgt.target_scores.sum(-1) * fg
    tgt_xyxy_g = tgt.target_boxes / stride[None, :, None]
    loss_iou = ((1.0 - ciou_xyxy(pred_xyxy_g, tgt_xyxy_g)) * weight).sum() / tss

    # the DFL targets: distances in grid units, inside the bins' range
    t_ltrb = torch.cat([axy_g[None] - tgt_xyxy_g[..., :2], tgt_xyxy_g[..., 2:] - axy_g[None]], -1)
    t_ltrb = t_ltrb.clamp(0.0, reg_max - 1 - 0.01)
    loss_dfl = (_dfl_ce(pred_dist, t_ltrb, reg_max) * weight).sum() / tss

    total = box_w * loss_iou + cls_w * loss_cls + dfl_w * loss_dfl
    return {"total_loss": total, "iou_loss": loss_iou, "cls_loss": loss_cls,
            "dfl_loss": loss_dfl, "num_fg": fg.sum() / B}
