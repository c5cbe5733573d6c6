"""TaskAligned label assignment (TAL) for the YOLOv8 DFL head (counterpart
of tscd_tpu/ops/tal.py), batched over frames directly:

  - candidates: anchors whose centre lies inside the gt box
  - alignment t = score[class]^alpha x IoU^beta (alpha 0.5, beta 6)
  - per gt the top-k (10) candidates by t (ties to the lower anchor, as
    lax.top_k)
  - an anchor claimed by more than one gt keeps the gt of highest IoU
    over all valid gts
  - cls target = one-hot x t, scaled per gt so that its largest t is its
    largest IoU

Dense (B, G, A) masked tensors, no host reads. As in JAX, the targets
stay differentiable in the predictions (the loss's gradient flows
through them).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import pairwise_iou_xyxy
from .nms import top_k

_EPS = 1e-9


class TALTargets(NamedTuple):
    fg_mask: torch.Tensor        # (B, A) bool
    target_boxes: torch.Tensor   # (B, A, 4) xyxy pixels, the matched gt's (garbage for bg)
    target_scores: torch.Tensor  # (B, A, C) aligned one-hot, 0 for bg
    matched_gt: torch.Tensor     # (B, A) int32 gt slot
    num_fg: torch.Tensor         # (B,) float


def tal_assign_batch(pd_scores: torch.Tensor, pd_boxes: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                     gt_valid: torch.Tensor, anchor_xy: torch.Tensor, num_classes: int,
                     topk: int = 10, alpha: float = 0.5, beta: float = 6.0) -> TALTargets:
    """pd_scores (B, A, C) sigmoided, pd_boxes (B, A, 4) xyxy pixels,
    gt_boxes (B, G, 4) xyxy pixels (zero-padded rows), gt_classes (B, G),
    gt_valid (B, G) bool, anchor_xy (A, 2) anchor centres in pixels."""
    B, A, _ = pd_scores.shape
    G = gt_boxes.shape[1]
    lt = anchor_xy[None, None] - gt_boxes[:, :, None, :2]           # (B, G, A, 2)
    rb = gt_boxes[:, :, None, 2:] - anchor_xy[None, None]
    in_gts = (torch.cat([lt, rb], -1).amin(-1) > _EPS) & gt_valid[..., None]

    overlaps = pairwise_iou_xyxy(gt_boxes, pd_boxes).clamp(min=0.0)  # (B, G, A)
    cls = gt_classes.long()[..., None].expand(B, G, A)
    cls_score = torch.gather(pd_scores.transpose(1, 2), 1, cls)      # (B, G, A)
    align = cls_score.clamp(min=0.0) ** alpha * overlaps ** beta
    align = torch.where(in_gts, align, torch.zeros_like(align))

    _, top_idx = top_k(align.detach(), min(topk, A))                 # (B, G, k)
    mask_topk = torch.zeros(B, G, A, dtype=torch.bool, device=align.device)
    mask_topk.scatter_(2, top_idx, True)
    mask_pos = mask_topk & in_gts & (align > 0)

    claims = mask_pos.sum(1)                                         # (B, A)
    best_gt = torch.where(gt_valid[..., None], overlaps,
                          torch.full_like(overlaps, -1.0)).argmax(1)
    only_gt = mask_pos.to(torch.uint8).argmax(1)
    matched_gt = torch.where(claims > 1, best_gt, only_gt)           # (B, A)
    fg_mask = claims > 0
    mask_pos = F.one_hot(matched_gt, G).transpose(1, 2).bool() & fg_mask[:, None]

    zero = torch.zeros_like(align)
    pos_align = torch.where(mask_pos, align, zero)
    pos_iou = torch.where(mask_pos, overlaps, zero)
    scale = pos_iou.amax(2) / (pos_align.amax(2) + _EPS)             # (B, G)
    anchor_score = (pos_align * scale[..., None]).amax(1)            # (B, A)

    cls_of_anchor = torch.gather(gt_classes.long(), 1, matched_gt)
    target_scores = (F.one_hot(cls_of_anchor, num_classes).to(anchor_score.dtype)
                     * torch.where(fg_mask, anchor_score, torch.zeros_like(anchor_score))[..., None])
    target_boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(B, A, 4))
    return TALTargets(fg_mask, target_boxes, target_scores, matched_gt.to(torch.int32),
                      fg_mask.float().sum(-1))
