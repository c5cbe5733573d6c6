"""DETR-style transformer decoder and Hungarian set criterion (counterpart
of tscd_tpu/models/decoder.py; reference decoder.py TransformerDecoder:20,
SetCriterion:394, matcher.py HungarianMatcher:12): fixed query slots,
gts padded to the query count with validity masks, the match solved on
the device by the hand solver (`ops.hungarian`), one launch a decoder
layer and no host read between them.

The attention is flax's MultiHeadDotProductAttention: query, key, value
and out projections with biases (flax DenseGeneral kernels (dim, heads,
head_dim) and (heads, head_dim, dim), nn.Linear here; `utils.convert`
reshapes them), scores scaled by 1 / sqrt(head_dim), masked keys at the
dtype's lowest value. LayerNorm eps is flax's 1e-6. The names are JAX's
(`layer0.cross_attn.query`, `norm1`, `ffn1`, `cls_0`, `box_0`,
`query_embed`, `input_proj`).
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import box_cxcywh_to_xyxy, pairwise_iou_xyxy
from ..ops.hungarian import masked_linear_sum_assignment


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention with qkv_features = out_features
    = dim over inputs of any leading dimensions."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (nn.Linear(dim, dim, dtype=dtype)
                                                      for _ in range(4))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        split = lambda t: t.unflatten(-1, (self.heads, -1))         # noqa: E731
        q, k, v = split(self.query(q)), split(self.key(k)), split(self.value(v))
        q = q / math.sqrt(q.shape[-1])
        scores = torch.einsum("...qhd,...khd->...hqk", q, k)
        if key_valid is not None:
            scores = scores.masked_fill(~key_valid, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, -1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", attn, v).flatten(-2))


class DecoderLayer(nn.Module):
    """Self-attention, cross-attention over the memory and an FFN, each
    followed by a residual and a LayerNorm (post-norm)."""

    def __init__(self, dim: int, heads: int = 8, ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads, dtype)
        self.cross_attn = MultiHeadAttention(dim, heads, dtype)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
                                              for _ in range(3))
        self.ffn1 = nn.Linear(dim, ffn_dim, dtype=dtype)
        self.ffn2 = nn.Linear(ffn_dim, dim, dtype=dtype)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, query_pos: torch.Tensor,
                memory_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos, memory, memory, memory_valid))
        return self.norm3(tgt + self.ffn2(F.relu(self.ffn1(tgt))))


class TransformerDecoder(nn.Module):
    """(decoder.py:20) learned object queries decode against flattened
    feature memory, with class and box heads on every layer's output (the
    auxiliary outputs)."""

    def __init__(self, num_classes: int, memory_dim: int, dim: int = 256, heads: int = 8,
                 num_layers: int = 6, num_queries: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.query_embed = nn.Parameter(torch.randn(num_queries, dim))
        self.input_proj = nn.Linear(memory_dim, dim, dtype=dtype)
        for i in range(num_layers):
            setattr(self, f"layer{i}", DecoderLayer(dim, heads, dtype=dtype))
            setattr(self, f"cls_{i}", nn.Linear(dim, num_classes + 1, dtype=dtype))
            setattr(self, f"box_{i}", nn.Linear(dim, 4, dtype=dtype))
        self.num_layers = num_layers

    def forward(self, memory: torch.Tensor, memory_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """memory (N, memory_dim) flattened features, memory_valid (N,)
        bool. Returns pred_logits (L, Q, C + 1) and pred_boxes (L, Q, 4),
        cxcywh in [0, 1] (fp32), one row a decoder layer."""
        memory = self.input_proj(memory.to(self.dtype))
        query_pos = self.query_embed.to(self.dtype)
        tgt = torch.zeros_like(query_pos)
        logits, boxes = [], []
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer{i}")(tgt, memory, query_pos, memory_valid)
            logits.append(getattr(self, f"cls_{i}")(tgt))
            boxes.append(torch.sigmoid(getattr(self, f"box_{i}")(tgt).float()))
        return {"pred_logits": torch.stack(logits), "pred_boxes": torch.stack(boxes)}


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| summed over the 4 coordinates, left to right."""
    d = (a - b).abs()
    return d[..., 0] + d[..., 1] + d[..., 2] + d[..., 3]


def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    gt_classes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                    cost_class: float = 1.0, cost_bbox: float = 5.0,
                    cost_giou: float = 2.0) -> torch.Tensor:
    """(matcher.py:12) col4row (Q,) int32: the gt slot of each query, on a
    cost of -prob + 5 L1 - 2 IoU (detached), invalid gt columns at the
    solver's `big`. The query count must equal the padded gt count."""
    with torch.no_grad():
        prob = torch.softmax(pred_logits.float(), -1)
        cls_cost = -prob[:, gt_classes.long()]                        # (Q, G)
        l1 = _l1(pred_boxes[:, None], gt_boxes[None])
        iou = pairwise_iou_xyxy(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(gt_boxes))
        cost = cost_class * cls_cost + cost_bbox * l1 + cost_giou * (-iou)
        return masked_linear_sum_assignment(
            cost, torch.ones(cost.shape[0], dtype=torch.bool, device=cost.device), gt_valid)


def set_criterion(outputs: Dict[str, torch.Tensor], gt_classes: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
                  eos_coef: float = 0.1) -> Dict[str, torch.Tensor]:
    """(decoder.py SetCriterion:394) the matched cross-entropy (no-object
    class weighted `eos_coef`), L1 and 1 - IoU over every decoder layer,
    averaged over the layers; gts padded to Q slots."""
    L, Q, _ = outputs["pred_logits"].shape
    num_gt = gt_valid.sum().clamp(min=1)
    rows = torch.arange(Q, device=gt_valid.device)
    ce_sum = bbox_sum = giou_sum = 0.0
    for i in range(L):
        logits = outputs["pred_logits"][i].float()
        boxes = outputs["pred_boxes"][i]
        col4row = hungarian_match(logits, boxes, gt_classes, gt_boxes, gt_valid).long()
        matched_valid = gt_valid[col4row]
        tgt_cls = torch.where(matched_valid, gt_classes[col4row].long(),
                              torch.full_like(col4row, num_classes))
        w = torch.where(matched_valid, 1.0, eos_coef)
        ce = -F.log_softmax(logits, -1)[rows, tgt_cls]
        ce_sum = ce_sum + (ce * w).sum() / w.sum()
        tgt_box = gt_boxes[col4row]
        bbox_sum = bbox_sum + (_l1(boxes, tgt_box) * matched_valid).sum() / num_gt
        iou = pairwise_iou_xyxy(box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(tgt_box))
        giou_sum = giou_sum + ((1.0 - iou.diagonal()) * matched_valid).sum() / num_gt
    losses = {"loss_ce": ce_sum / L, "loss_bbox": bbox_sum / L, "loss_giou": giou_sum / L}
    losses["total_loss"] = (losses["loss_ce"] + 5.0 * losses["loss_bbox"]
                            + 2.0 * losses["loss_giou"])
    return losses
