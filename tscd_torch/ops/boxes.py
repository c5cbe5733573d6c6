"""Box geometry (counterpart of tscd_tpu/ops/boxes.py), batched over
any leading dimensions."""

import math

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


def bboxes_iou(a: torch.Tensor, b: torch.Tensor, xyxy: bool = True,
               eps: float = 1e-16) -> torch.Tensor:
    """Pairwise IoU as yolox/utils/boxes.py:131; `xyxy=False` reads cxcywh
    boxes (the form SimOTA compares gt and predictions in)."""
    if not xyxy:
        a, b = box_cxcywh_to_xyxy(a), box_cxcywh_to_xyxy(b)
    return pairwise_iou_xyxy(a, b, eps)


def iou_loss_cxcywh(pred: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-16) -> torch.Tensor:
    """Elementwise 1 - IoU^2 of aligned cxcywh boxes (..., 4) -> (...),
    the 'iou' loss of yolox/models/losses.py:9."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2,
                       target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2,
                       target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]
    area_g = target[..., 2] * target[..., 3]
    en = (tl < br).all(-1).to(pred.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    iou = area_i / (area_p + area_g - area_i + eps)
    return 1.0 - iou ** 2


def ciou_xyxy(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise Complete-IoU of aligned xyxy boxes (..., 4) -> (...): IoU
    - centre distance^2 / enclosing diagonal^2 - v alpha (the DFL head's
    box loss, tscd_tpu/ops/boxes.py:62), alpha detached as JAX's
    stop_gradient."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    pw, ph = px2 - px1, py2 - py1
    tw, th = tx2 - tx1, ty2 - ty1
    inter = ((torch.minimum(px2, tx2) - torch.maximum(px1, tx1)).clamp(min=0.0)
             * (torch.minimum(py2, ty2) - torch.maximum(py1, ty1)).clamp(min=0.0))
    iou = inter / (pw * ph + tw * th - inter + eps)
    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw * cw + ch * ch + eps
    rho2 = ((px1 + px2 - tx1 - tx2) ** 2 + (py1 + py2 - ty1 - ty2) ** 2) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(tw / th.clamp(min=eps))
                                - torch.atan(pw / ph.clamp(min=eps))) ** 2
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
