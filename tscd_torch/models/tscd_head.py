"""TSCD head (counterpart of tscd_tpu/models/tscd_head.py; reference
yolox/models/tscd_head.py:26): every branch of JAX's TSCDHead.

Fixed P proposal slots per frame with validity masks; every stage is a
fixed-shape tensor op, so the eval forward takes no host sync and a
window captures as one CUDA graph in every branch. Towers, edge block,
aggregation and matcher run in the compute dtype (`dtype`); decode and
proposal selection read the raw outputs in fp32 (tscd_head.py:263), and
at bf16 those hold many exact ties, which the stable top-k ranks lowest
anchor first as `lax.top_k` does.

The branches, as JAX's fields of the same names: proposals by plain
top-k, by `use_pre_nms` (top 750 by objectness, class-aware NMS at
`pre_nms` through the hand NMS kernel, the top P survivors) or, at train
time with `labels`, `cat_ota_fg` (SimOTA's foreground anchors ranked
first); the video towers dense, or on proposal patches with
`sparse_vid_towers` where BN runs on its running statistics
(`models/sparse_towers.py`), or the still towers' outputs where
`vid_cls`/`vid_reg` are off; `agg_type` "mca", "mca_aware" (the reg
features SE-gated with the edge features of every frame) or "localagg"
(the YOLOV family's LocalAggregation over every frame's proposals, then
Linear cls, obj and reg preds on the local frames; no matcher, as JAX
composes it, tscd_head.py:320-354); `ave`;
`use_mask`; `decouple_reg` (the reg aggregation, the CAFM matcher and
TaskAligned; without it no matcher_* or refined_boxes output) and
`reconf` (the matcher's obj and offset heads).
"""

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..ops.boxes import box_cxcywh_to_xyxy
from ..ops.decode import anchor_centers, decode_outputs
from ..ops.nms import batched_class_aware_nms, top_k
from ..ops.simota import labels_to_padded, simota_assign
from ..ops.wavelets import WaveletsHFBlock
from .aggregation import MCAg2l, MCAg2lAware
from .blocks import BaseConv, BNStats, conv_cls, run
from .matching import MatcherState, RegMatcher, TaskAligned, init_matcher_state
from .sparse_towers import sparse_vid_tower_features
from .yolo_head import flatten_levels

PRE_NMS_TOP = 750         # anchors ranked by objectness before the pre-NMS


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
                           conf_thresh: float, minimal_limit: int,
                           nms_thre: float = 0.75, use_pre_nms: bool = False,
                           ota_fg: Optional[torch.Tensor] = None
                           ) -> FrameProposals:
    """Fixed-P proposal selection per frame (postprocess_widx,
    tscd_head.py:1546): score = obj * best-class prob; the top p slots,
    valid above conf_thresh or below rank minimal_limit. Ties rank the
    lower anchor first, as lax.top_k.

    `use_pre_nms` (postpro_woclass, post_process.py:464): the top 750
    anchors by objectness alone, class-aware NMS at `nms_thre` scored by
    obj * cls (one hand-kernel call over the F frames), the top p
    survivors, valid where they survived, with no conf gate.
    `ota_fg` (F, A) bool, SimOTA's foreground anchors (cat_ota_fg at
    train time, :1583-1589): they rank first (+2 on the score, which
    lies in [0, 1]) and are valid; the other slots fill by score."""
    boxes = box_cxcywh_to_xyxy(decoded[..., :4])
    obj = decoded[..., 4]
    cls_scores = decoded[..., 5:5 + num_classes]
    cls_conf = cls_scores.amax(-1)
    cls_id = cls_scores.argmax(-1)
    score = obj * cls_conf
    rank = torch.arange(p, device=decoded.device)
    if use_pre_nms:
        top_o, top_i = top_k(obj, min(PRE_NMS_TOP, obj.shape[-1]))
        nms_scores = top_o * _gather_rows(cls_conf, top_i)
        keep = batched_class_aware_nms(
            _gather_rows(boxes, top_i), nms_scores, _gather_rows(cls_id, top_i),
            torch.ones_like(nms_scores, dtype=torch.bool), nms_thre)
        out_s, pick = top_k(torch.where(keep, nms_scores, -torch.inf), p)
        idx = torch.gather(top_i, 1, pick)
        valid = out_s > -torch.inf
    elif ota_fg is not None:
        _, idx = top_k(score + 2.0 * ota_fg.to(score.dtype), p)
        valid = (_gather_rows(ota_fg, idx) | (_gather_rows(score, idx) >= conf_thresh)
                 | (rank < minimal_limit))
    else:
        out_s, idx = top_k(score, p)
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
    """JAX's TSCDHead (tscd_head.py:143), its fields as arguments; see
    the module docstring for the branches. The parameters are the
    reference's state_dict names; a branch that is off builds none of its
    modules, as flax creates none."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 act: str = "silu", depthwise: bool = False, heads: int = 4,
                 agg_type: str = "mca", decoder_layer_num: int = 1,
                 num_proposals: int = 50, minimal_limit: Optional[int] = None,
                 cat_ota_fg: bool = False, pre_nms: float = 0.75,
                 sim_thresh: float = 0.75, ave: bool = True,
                 test_conf: float = 0.001, use_mask: bool = False,
                 conf_sim_thresh: float = 0.99, use_pre_nms: bool = False,
                 reconf: bool = True, decouple_reg: bool = True,
                 vid_cls: bool = True, vid_reg: bool = True,
                 sparse_vid_towers: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if agg_type not in ("mca", "mca_aware", "localagg"):
            raise ValueError(f"agg_type {agg_type!r}: 'mca', 'mca_aware' or 'localagg'")
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.hidden = hidden = int(256 * width)
        self.num_proposals = num_proposals
        self.minimal_limit = (num_proposals if minimal_limit is None
                              else minimal_limit)
        self.agg_type = agg_type
        self.cat_ota_fg = cat_ota_fg
        self.pre_nms = pre_nms
        self.use_pre_nms = use_pre_nms
        self.sim_thresh = sim_thresh
        self.conf_sim_thresh = conf_sim_thresh
        self.test_conf = test_conf
        self.use_mask = use_mask
        self.reconf = reconf
        self.decouple_reg = decouple_reg
        self.vid_cls = vid_cls
        self.vid_reg = vid_reg
        self.sparse_vid_towers = sparse_vid_towers
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
        if vid_cls:
            self.cls_convs2 = nn.ModuleList(tower() for _ in range(n))
        if vid_reg:
            self.reg_convs2 = nn.ModuleList(tower() for _ in range(n))
        self.edge_enhance_reg = nn.ModuleList(
            nn.Sequential(WaveletsHFBlock(hidden, dtype)) for _ in range(n))
        if agg_type == "localagg":
            # imported here: yolov_heads builds on this module
            from .yolov_heads import LocalAggregation
            self.agg = LocalAggregation(hidden, heads, reconf=reconf, dtype=dtype)
            self.cls_pred = nn.Linear(hidden, num_classes, dtype=dtype)
            if reconf:
                self.obj_pred = nn.Linear(hidden, 1, dtype=dtype)
                self.reg_pred = nn.Linear(hidden, 4, dtype=dtype)
            return
        Agg = MCAg2lAware if agg_type == "mca_aware" else MCAg2l
        self.agg = Agg(hidden, 4 * hidden, heads, reconf=False, ave=ave, dtype=dtype)
        if decouple_reg:
            self.agg_iou = Agg(hidden, 4 * hidden, heads, reconf=True, ave=ave,
                               dtype=dtype)
            self.local_reg_matcher = RegMatcher(hidden, num_heads=8,
                                                num_layers=decoder_layer_num,
                                                dtype=dtype)
            self.fc_reg_matcher = nn.Linear(hidden, 4 * hidden, dtype=dtype)
            self.task_aligned = TaskAligned(4 * hidden, num_heads=8,
                                            num_layers=1, dtype=dtype)
            if reconf:
                self.matcher_obj_pred = nn.Linear(4 * hidden, 1, dtype=dtype)
                self.matcher_reg_pred = nn.Linear(4 * hidden, 4, dtype=dtype)
        self.cls_pred = nn.Linear(4 * hidden, num_classes, dtype=dtype)

    @property
    def edge_all_frames(self) -> bool:
        """The edge features are read on every frame only by the
        edge-aware aggregator; 'mca' reads them on the local frames
        (RegMatcher), so the global frames' are skipped (tscd_head.py:201)."""
        return self.agg_type == "mca_aware"

    def vid_features(self, stem_feats: Sequence[torch.Tensor], still, idx: torch.Tensor,
                     lframe: int, stats: Optional[BNStats], sparse: bool):
        """The proposals' video-tower and edge features (f_cls, f_reg (F,
        P, hid), f_edge (F or lframe, P, hid)) at anchors idx (F, P), from
        the stems' outputs (per level (F, hid, h, w)): on proposal
        patches with `sparse`, else from the dense maps (find_feature_score,
        :976). `still` per level (cls, reg) still-tower outputs stand in
        where vid_cls / vid_reg is off."""
        edge_all = self.edge_all_frames
        if sparse:
            return sparse_vid_tower_features(
                stem_feats, idx, self.cls_convs2, self.reg_convs2,
                self.edge_enhance_reg, lframe, edge_all, stats)
        cls_vid, reg_vid, edges = [], [], []
        for k, x in enumerate(stem_feats):
            cls_vid.append(run(self.cls_convs2[k], x, stats) if self.vid_cls else still[k][0])
            reg_vid.append(run(self.reg_convs2[k], x, stats) if self.vid_reg else still[k][1])
            edges.append(self.edge_enhance_reg[k](
                reg_vid[-1] if edge_all else reg_vid[-1][:lframe]))
        return (_gather_rows(flatten_levels(cls_vid), idx),
                _gather_rows(flatten_levels(reg_vid), idx),
                _gather_rows(flatten_levels(edges), idx if edge_all else idx[:lframe]))

    def forward(self, xin: Sequence[torch.Tensor],
                time_embedding: torch.Tensor, lframe: int,
                matcher_state: Optional[MatcherState] = None,
                stats: Optional[BNStats] = None,
                labels: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """xin: 3 FPN levels, each (F, c, h, w), frames [local...,
        global...]; time_embedding (F, 256); `stats` the BN mode of the
        stems and towers (`blocks.batch_norm`; JAX's head gates only BN
        on `train`, tscd_head.py:211-249); `labels` (F, G, 5), given by
        the train steps, switch on the cat_ota_fg injection (JAX gates it
        on their presence, not on `train`). Returns raw + refined outputs,
        the matcher state (the new one, or the one given where there is no
        matcher) and, where SimOTA ran, its targets under "simota"."""
        C = self.num_classes
        P = self.num_proposals
        level_outputs, hw, stem_feats, still = [], [], [], []
        for k, x in enumerate(xin):
            hw.append((x.shape[2], x.shape[3]))
            x = self.stems[k](x, stats)
            cls_f = run(self.cls_convs[k], x, stats)
            reg_f = run(self.reg_convs[k], x, stats)
            level_outputs.append(torch.cat(
                [self.reg_preds[k](reg_f), self.obj_preds[k](reg_f),
                 self.cls_preds[k](cls_f)], 1))
            stem_feats.append(x)
            # the still towers' maps stand in for a video tower switched off
            still.append(None if self.vid_cls and self.vid_reg else (cls_f, reg_f))

        raw_outputs = flatten_levels(level_outputs)          # (F, A, 5+C)
        raw32 = raw_outputs.to(torch.float32)
        dec = decode_outputs(raw32, hw, self.strides)
        decoded = torch.cat([dec[..., :4], torch.sigmoid(dec[..., 4:])], -1)
        out: Dict[str, Any] = {"raw_outputs": raw_outputs, "hw": hw,
                               "decoded": decoded, "matcher_state": matcher_state}

        # cat_ota_fg (tscd_head.py:279-291): SimOTA here, its foreground
        # anchors ranked into the slots; the loss reuses out["simota"]
        ota_fg = None
        if self.cat_ota_fg and labels is not None:
            with torch.no_grad():
                gt_boxes, gt_classes, gt_valid = labels_to_padded(labels.to(torch.float32))
                tgt = simota_assign(dec[..., :4], raw32[..., 4], raw32[..., 5:],
                                    gt_boxes, gt_classes, gt_valid,
                                    *anchor_centers(hw, self.strides, raw32.device))
            out["simota"] = tgt
            ota_fg = tgt.fg_mask
        # proposals come from the detached decode (tscd_head.py:294): their
        # scores, boxes and anchor indices carry no gradient
        props = select_frame_proposals(decoded.detach(), C, P, self.test_conf,
                                       self.minimal_limit, self.pre_nms,
                                       self.use_pre_nms, ota_fg)
        out["proposals"] = props

        sparse = (self.sparse_vid_towers and stats is None
                  and self.vid_cls and self.vid_reg)
        f_cls, f_reg, f_edge = self.vid_features(stem_feats, still, props.idx,
                                                 lframe, stats, sparse)

        if self.agg_type == "localagg":
            return self._local_agg(out, f_cls, f_reg, props, lframe, xin[0])
        kw = dict(sim_thresh=self.sim_thresh, use_mask=self.use_mask,
                  conf_sim_thresh=self.conf_sim_thresh)
        # the aggregators' inputs: with mca_aware the edge features of
        # every frame's proposals ride along
        agg_in = ((f_cls, f_reg, f_edge) if self.edge_all_frames else (f_cls, f_reg))
        agg_in += (props.cls_conf, props.obj, props.valid, lframe)
        # cross-frame aggregation: cls branch (:480), reg branch (:491)
        agg_cls, _ = self.agg(*agg_in, **kw)
        if self.decouple_reg:
            agg_iou_cls, agg_obj = self.agg_iou(*agg_in, **kw)
            if matcher_state is None:
                matcher_state = init_matcher_state(
                    P, self.hidden, 4 * self.hidden, dtype=f_reg.dtype,
                    device=f_reg.device)
            local_valid = props.valid[:lframe]
            matched, out["matcher_state"] = self.local_reg_matcher(
                f_reg[:lframe], agg_obj, agg_iou_cls, f_edge[:lframe],
                time_embedding[:lframe].to(f_reg.dtype), local_valid,
                matcher_state)
            matched4 = self.fc_reg_matcher(matched)             # (L, P, 4h)
            # TaskAligned feeds only the reconf obj head (:403-409)
            if self.reconf:
                obj_refined = self.task_aligned(matched4, agg_obj, local_valid)
                out["matcher_obj_logits"] = self.matcher_obj_pred(obj_refined)[..., 0]
                out["matcher_reg_offsets"] = self.matcher_reg_pred(matched4)
        out["refined_cls_logits"] = self.cls_pred(agg_cls)
        if "matcher_reg_offsets" in out:
            out["refined_boxes"] = decode_reg_offsets(
                out["matcher_reg_offsets"].to(torch.float32), props.boxes[:lframe])
        return out

    def _local_agg(self, out: Dict[str, Any], f_cls: torch.Tensor, f_reg: torch.Tensor,
                   props: FrameProposals, lframe: int, x0: torch.Tensor) -> Dict[str, Any]:
        """agg_type "localagg" (tscd_head.py:320-354): LocalAggregation over
        every frame's proposals, refined cls on the local frames and with
        `reconf` the obj logits and reg offsets as the matcher's outputs
        (their decoded boxes `refined_boxes`); the matcher state passes
        through."""
        F_, P = props.boxes.shape[:2]
        hid = self.hidden
        agg_c, agg_r = self.agg(f_cls.reshape(-1, hid), f_reg.reshape(-1, hid),
                                props.boxes.reshape(-1, 4), props.cls_conf.reshape(-1),
                                props.obj.reshape(-1), props.valid.reshape(-1), F_, P,
                                x0.shape[3] * self.strides[0], x0.shape[2] * self.strides[0])
        agg_c = agg_c.reshape(F_, P, -1)[:lframe]
        agg_r = agg_r.reshape(F_, P, -1)[:lframe]
        out["refined_cls_logits"] = self.cls_pred(agg_c)
        if self.reconf:
            out["matcher_obj_logits"] = self.obj_pred(agg_r)[..., 0]
            out["matcher_reg_offsets"] = self.reg_pred(agg_r)
            out["refined_boxes"] = decode_reg_offsets(
                out["matcher_reg_offsets"].to(torch.float32), props.boxes[:lframe])
        return out
