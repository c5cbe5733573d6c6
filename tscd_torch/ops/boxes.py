"""Box geometry (counterpart of tscd_tpu/ops/boxes.py), batched over
any leading dimensions."""

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def pairwise_iou_xyxy(a: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-16) -> torch.Tensor:
    """IoU of every pair: a (..., N, 4), b (..., M, 4) xyxy -> (..., N, M)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0.0)
              * (a[..., 3] - a[..., 1]).clamp(min=0.0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0.0)
              * (b[..., 3] - b[..., 1]).clamp(min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / (union + eps)
