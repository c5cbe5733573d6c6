"""Fixed-shape NMS (counterpart of tscd_tpu/ops/nms.py), batched over a
leading frame axis.

Greedy NMS keeps box i (in score order) when it is valid and no earlier
KEPT box overlaps it. The JAX package builds the IoU matrix and runs a
K-step scan; here the score order, the gathers and the scatter are
torch, and the IoU, its threshold and the K-step walk are the hand
kernels behind `ops.kernels.nms.nms_sorted`, which on the card write no
(K, K) tensor and wait on nothing.
"""

import torch

from .kernels.nms import nms_sorted


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, ties to the lower
    index (torch.topk promises no tie order, a stable sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def score_order(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The stable descending score order (B, K) (invalid slots last, ties
    to the lower slot, as JAX's argsort), and the boxes and valid flags
    in that order: the hand kernels' inputs."""
    B, K = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, K, 4))
    return order, boxes_s, torch.gather(valid, 1, order)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) xyxy fp32, scores (B, K), valid (B, K) bool ->
    keep (B, K) bool. Invalid slots neither keep nor suppress."""
    order, boxes_s, valid_s = score_order(boxes, scores, valid)
    keep = nms_sorted(boxes_s, valid_s, iou_threshold)
    return torch.zeros_like(valid).scatter(1, order, keep)


def class_shift(boxes: torch.Tensor, class_ids: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Each class's boxes moved to a region of its own: + class id x
    (the frame's largest valid coordinate + 1)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    span = masked.amax(dim=(-2, -1), keepdim=True) + 1.0       # (B, 1, 1)
    return boxes + class_ids.to(boxes.dtype)[..., None] * span


def batched_class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                            class_ids: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS via per-class coordinate offsets (one pass);
    shapes as in `nms_fixed`, class_ids (B, K)."""
    return nms_fixed(class_shift(boxes, class_ids, valid), scores, valid,
                     iou_threshold)
