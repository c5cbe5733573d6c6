"""Fixed-shape NMS (counterpart of tscd_tpu/ops/nms.py), batched over a
leading frame axis.

Greedy NMS keeps box i (in score order) when it is valid and no earlier
KEPT box overlaps it. The JAX package runs that as a K-step scan; here
the overlap matrix is torch and the K-step walk is the hand kernel
`ops.kernels.nms.nms_walk`, which on the card waits on nothing.
"""

import torch

from .boxes import pairwise_iou_xyxy
from .kernels.nms import nms_walk


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, ties to the lower
    index (torch.topk promises no tie order, a stable sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def suppression_matrix(boxes: torch.Tensor, scores: torch.Tensor,
                       valid: torch.Tensor, iou_threshold: float):
    """The walk's inputs: the stable score order (B, K), sup (B, K, K)
    bool in that order with sup[b, i, j] = box j comes before box i and
    overlaps it above the threshold, and valid (B, K) in that order."""
    B, K = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, K, 4))
    valid_s = torch.gather(valid, 1, order)
    overlap = pairwise_iou_xyxy(boxes_s, boxes_s) > iou_threshold
    earlier = torch.ones(K, K, dtype=torch.bool, device=boxes.device).tril(-1)
    return order, overlap & earlier, valid_s


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """boxes (B, K, 4) xyxy, scores (B, K), valid (B, K) bool ->
    keep (B, K) bool. Score order is stable (ties go to the lower slot);
    invalid slots neither keep nor suppress."""
    order, sup, valid_s = suppression_matrix(boxes, scores, valid,
                                             iou_threshold)
    keep = nms_walk(sup, valid_s)
    return torch.zeros_like(valid).scatter(1, order, keep)


def batched_class_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                            class_ids: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS via per-class coordinate offsets (one pass);
    shapes as in `nms_fixed`, class_ids (B, K)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    span = masked.amax(dim=(-2, -1), keepdim=True) + 1.0       # (B, 1, 1)
    shifted = boxes + class_ids.to(boxes.dtype)[..., None] * span
    return nms_fixed(shifted, scores, valid, iou_threshold)
