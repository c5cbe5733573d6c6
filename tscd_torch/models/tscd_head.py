"""TSCD head (counterpart of tscd_tpu/models/tscd_head.py; reference
yolox/models/tscd_head.py:26), on the TSCD-Large eval path: MCA
aggregation, decoupled reg branch with the CAFM matcher, reconf heads,
proposal selection by plain top-k (no pre-NMS).

Fixed P proposal slots per frame with validity masks; every stage is a
fixed-shape tensor op, so the forward takes no host sync. Towers, edge
block, aggregation and matcher run in the compute dtype (`dtype`);
decode and proposal selection read the raw outputs in fp32
(tscd_head.py:263), and at bf16 those hold many exact ties, which the
stable top-k ranks lowest anchor first as `lax.top_k` does. The
`use_pre_nms`, `cat_ota_fg`, `localagg`, `mca_aware` and sparse-tower
branches of the JAX head are not ported yet.
"""

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..ops.boxes import box_cxcywh_to_xyxy
from ..ops.decode import decode_outputs
from ..ops.nms import top_k
from ..ops.wavelets import WaveletsHFBlock
from .aggregation import MCAg2l
from .blocks import BaseConv, BNStats, conv_cls, run
from .matching import MatcherState, RegMatcher, TaskAligned, init_matcher_state
from .yolo_head import flatten_levels


class FrameProposals(NamedTuple):
    boxes: torch.Tensor       # (F, P, 4) xyxy pixels (still-detector boxes)
    obj: torch.Tensor         # (F, P) sigmoided objectness
    cls_conf: torch.Tensor    # (F, P) best class prob
    cls_id: torch.Tensor      # (F, P)
    cls_scores: torch.Tensor  # (F, P, C)
    idx: torch.Tensor         # (F, P) anchor index of each proposal
    valid: torch.Tensor       # (F, P) bool


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (F, A, ...) , idx (F, P) -> (F, P, ...)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def select_frame_proposals(decoded: torch.Tensor, num_classes: int, p: int,
                           conf_thresh: float, minimal_limit: int
                           ) -> FrameProposals:
    """Fixed-P proposal selection per frame (postprocess_widx,
    tscd_head.py:1546), plain top-k branch: score = obj * best-class
    prob; the top p slots, valid above conf_thresh or below rank
    minimal_limit. Ties rank the lower anchor first, as lax.top_k."""
    boxes = box_cxcywh_to_xyxy(decoded[..., :4])
    obj = decoded[..., 4]
    cls_scores = decoded[..., 5:5 + num_classes]
    cls_conf = cls_scores.amax(-1)
    cls_id = cls_scores.argmax(-1)
    out_s, idx = top_k(obj * cls_conf, p)
    rank = torch.arange(p, device=decoded.device)
    valid = (out_s >= conf_thresh) | (rank < minimal_limit)
    return FrameProposals(_gather_rows(boxes, idx), _gather_rows(obj, idx),
                          _gather_rows(cls_conf, idx),
                          _gather_rows(cls_id, idx),
                          _gather_rows(cls_scores, idx), idx, valid)


def encode_reg_targets(gt_cxcywh: torch.Tensor, still_boxes: torch.Tensor,
                       eps: float = 1e-8) -> torch.Tensor:
    """Inverse of decode_reg_offsets (encode_reg_preds, tscd_head.py:951):
    cxcywh targets + still-detector xyxy boxes -> dx/dy/dw/dh."""
    w = still_boxes[..., 2] - still_boxes[..., 0]
    h = still_boxes[..., 3] - still_boxes[..., 1]
    cx = still_boxes[..., 0] + 0.5 * w
    cy = still_boxes[..., 1] + 0.5 * h
    return torch.stack([(gt_cxcywh[..., 0] - cx) / w,
                        (gt_cxcywh[..., 1] - cy) / h,
                        torch.log(gt_cxcywh[..., 2] / w + eps),
                        torch.log(gt_cxcywh[..., 3] / h + eps)], -1)


def decode_reg_offsets(offsets: torch.Tensor, still_boxes: torch.Tensor,
                       clip: float = math.log(736.0 / 32)) -> torch.Tensor:
    """dx/dy/dw/dh offsets + still-detector xyxy boxes -> refined xyxy
    (decode_reg_preds5, tscd_head.py:914)."""
    w = still_boxes[..., 2] - still_boxes[..., 0]
    h = still_boxes[..., 3] - still_boxes[..., 1]
    cx = still_boxes[..., 0] + 0.5 * w
    cy = still_boxes[..., 1] + 0.5 * h
    dw = offsets[..., 2].clamp(max=clip)
    dh = offsets[..., 3].clamp(max=clip)
    pcx = offsets[..., 0] * w + cx
    pcy = offsets[..., 1] * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


class TSCDHead(nn.Module):
    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", depthwise: bool = False, heads: int = 4,
                 decoder_layer_num: int = 1, num_proposals: int = 50,
                 minimal_limit: Optional[int] = None,
                 sim_thresh: float = 0.75, conf_sim_thresh: float = 0.99,
                 test_conf: float = 0.001, use_mask: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.hidden = hidden = int(256 * width)
        self.num_proposals = num_proposals
        self.minimal_limit = (num_proposals if minimal_limit is None
                              else minimal_limit)
        self.sim_thresh = sim_thresh
        self.conf_sim_thresh = conf_sim_thresh
        self.test_conf = test_conf
        self.use_mask = use_mask
        Conv = conv_cls(depthwise)
        n = len(in_channels)
        kw = dict(act=act, dtype=dtype)

        def tower():
            return nn.Sequential(Conv(hidden, hidden, 3, 1, **kw),
                                 Conv(hidden, hidden, 3, 1, **kw))

        self.stems = nn.ModuleList(
            BaseConv(int(c * width), hidden, 1, 1, **kw) for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in range(n))
        self.reg_convs = nn.ModuleList(tower() for _ in range(n))
        self.cls_preds = nn.ModuleList(
            nn.Conv2d(hidden, num_classes, 1, dtype=dtype) for _ in range(n))
        self.reg_preds = nn.ModuleList(
            nn.Conv2d(hidden, 4, 1, dtype=dtype) for _ in range(n))
        self.obj_preds = nn.ModuleList(
            nn.Conv2d(hidden, 1, 1, dtype=dtype) for _ in range(n))
        # extra video towers (tscd_head.py:240-281) and the per-level
        # wavelet edge block on the reg branch (:206-212)
        self.cls_convs2 = nn.ModuleList(tower() for _ in range(n))
        self.reg_convs2 = nn.ModuleList(tower() for _ in range(n))
        self.edge_enhance_reg = nn.ModuleList(
            nn.Sequential(WaveletsHFBlock(hidden, dtype)) for _ in range(n))
        self.agg = MCAg2l(hidden, 4 * hidden, heads, reconf=False, dtype=dtype)
        self.agg_iou = MCAg2l(hidden, 4 * hidden, heads, reconf=True,
                              dtype=dtype)
        self.local_reg_matcher = RegMatcher(hidden, num_heads=8,
                                            num_layers=decoder_layer_num,
                                            dtype=dtype)
        self.fc_reg_matcher = nn.Linear(hidden, 4 * hidden, dtype=dtype)
        self.task_aligned = TaskAligned(4 * hidden, num_heads=8, num_layers=1,
                                        dtype=dtype)
        self.cls_pred = nn.Linear(4 * hidden, num_classes, dtype=dtype)
        self.matcher_obj_pred = nn.Linear(4 * hidden, 1, dtype=dtype)
        self.matcher_reg_pred = nn.Linear(4 * hidden, 4, dtype=dtype)

    def forward(self, xin: Sequence[torch.Tensor],
                time_embedding: torch.Tensor, lframe: int,
                matcher_state: Optional[MatcherState] = None,
                stats: Optional[BNStats] = None) -> Dict[str, Any]:
        """xin: 3 FPN levels, each (F, c, h, w), frames [local...,
        global...]; time_embedding (F, 256); `stats` the BN mode of the
        stems and towers (`blocks.batch_norm`; JAX's head gates only BN
        on `train`, tscd_head.py:211-249). Returns raw + refined outputs
        and the new matcher state."""
        C = self.num_classes
        P = self.num_proposals
        level_outputs, hw = [], []
        cls_vid, reg_vid, edges = [], [], []
        for k, x in enumerate(xin):
            hw.append((x.shape[2], x.shape[3]))
            x = self.stems[k](x, stats)
            cls_f = run(self.cls_convs[k], x, stats)
            reg_f = run(self.reg_convs[k], x, stats)
            level_outputs.append(torch.cat(
                [self.reg_preds[k](reg_f), self.obj_preds[k](reg_f),
                 self.cls_preds[k](cls_f)], 1))
            cls_vid.append(run(self.cls_convs2[k], x, stats))
            reg_vid.append(run(self.reg_convs2[k], x, stats))
            # the 'mca' path reads edge features of the local frames only
            edges.append(self.edge_enhance_reg[k](reg_vid[-1][:lframe]))

        raw_outputs = flatten_levels(level_outputs)          # (F, A, 5+C)
        dec = decode_outputs(raw_outputs.to(torch.float32), hw, self.strides)
        decoded = torch.cat([dec[..., :4], torch.sigmoid(dec[..., 4:])], -1)
        # proposals come from the detached decode (tscd_head.py:294): their
        # scores, boxes and anchor indices carry no gradient
        props = select_frame_proposals(decoded.detach(), C, P, self.test_conf,
                                       self.minimal_limit)
        out: Dict[str, Any] = {"raw_outputs": raw_outputs, "hw": hw,
                               "decoded": decoded, "proposals": props}

        # gather per-proposal features (find_feature_score, :976)
        f_cls = _gather_rows(flatten_levels(cls_vid), props.idx)   # (F, P, hid)
        f_reg = _gather_rows(flatten_levels(reg_vid), props.idx)
        f_edge = _gather_rows(flatten_levels(edges), props.idx[:lframe])

        kw = dict(sim_thresh=self.sim_thresh, use_mask=self.use_mask,
                  conf_sim_thresh=self.conf_sim_thresh)
        # cross-frame aggregation: cls branch (:480), reg branch (:491)
        agg_cls, _ = self.agg(f_cls, f_reg, props.cls_conf, props.obj,
                              props.valid, lframe, **kw)
        agg_iou_cls, agg_obj = self.agg_iou(
            f_cls, f_reg, props.cls_conf, props.obj, props.valid, lframe, **kw)

        if matcher_state is None:
            matcher_state = init_matcher_state(
                P, self.hidden, 4 * self.hidden, dtype=f_reg.dtype,
                device=f_reg.device)
        local_valid = props.valid[:lframe]
        matched, new_state = self.local_reg_matcher(
            f_reg[:lframe], agg_obj, agg_iou_cls, f_edge,
            time_embedding[:lframe].to(f_reg.dtype), local_valid,
            matcher_state)
        out["matcher_state"] = new_state

        matched4 = self.fc_reg_matcher(matched)                 # (L, P, 4h)
        obj_refined = self.task_aligned(matched4, agg_obj, local_valid)
        out["matcher_obj_logits"] = self.matcher_obj_pred(obj_refined)[..., 0]
        out["matcher_reg_offsets"] = self.matcher_reg_pred(matched4)
        out["refined_cls_logits"] = self.cls_pred(agg_cls)
        out["refined_boxes"] = decode_reg_offsets(
            out["matcher_reg_offsets"].to(torch.float32), props.boxes[:lframe])
        return out
