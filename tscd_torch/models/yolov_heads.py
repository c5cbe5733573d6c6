"""YOLOV family heads of the port (counterpart of
tscd_tpu/models/yolov_heads.py: the offline heads YOLOVHead and
YOLOVPlusHead, and LocalAggregation; reference yolovp_msa.py:22,
v_plus_head.py:24, post_trans.py:47,184,199,972).

Fixed P proposal slots per frame with validity masks, as the TSCD head:
the still towers and preds, the proposals (the TSCD head's selection,
the pre-NMS through the hand NMS kernel), the video towers' features at
the proposals' anchors, then one aggregator over the window:
  - YOLOV: MSA self-attention over every proposal of every frame (one
    launch of the hand attention kernel at q = k = F x P), refined cls
    (and obj with `reconf`) on every frame;
  - YOLOV++: `agg_type` "msa" (with `decouple_reg` a second MSA, named
    `agg_iou`, gives the obj features: two launches), "mca" (each local
    frame against the global ones, the TSCD head's MCAg2l) or
    "localagg" (LocalAggregation, plain tensor work: scaled dot-product
    attention with a box-relation bias, as JAX runs it without a Pallas
    kernel); the refined rows are the first L = max(lframe, 1) frames, or
    all F with lframe 0.

Parameters are the reference's state_dict names (`stems.0`,
`cls_convs2.0.1`, `agg.msa.qkv_cls`, `agg.transBlocks.0.self_attn.qkv`,
`agg.transBlocks.0.mlp.net.0`, ...); `utils.convert` maps them to JAX's
(`towers/stem_0`, `agg/block_0/attn/qkv`, `agg/block_0/mlp/fc1`).

The online head (yolov_heads.py:583-796; reference yolov_msa_online.py:27):
one frame a call, its P proposals and an `OnlineBank` carried between
calls (ring buffers with pointers and validity masks on the device, and
no host read of them), the square MSA over current ++ bank through the
hand attention kernel with the reg branch's fg-score guidance, the merge
against the local msa memory (`local_agg_merge`), refined cls logits.
"""

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import pairwise_iou_xyxy
from ..ops.decode import decode_outputs
from ..ops.position import get_timing_signal_1d
from .aggregation import MCAg2l, MSAYolov, _l2norm, _merge_heads, _split_heads
from .blocks import BaseConv, BNStats, conv_cls, run
from .matching import LN_EPS, _layer_norm, extract_position_embedding, extract_position_matrix
from .tscd_head import FrameProposals, _gather_rows, select_frame_proposals
from .yolo_head import flatten_levels

NEG = -1e9
PRE_NMS = 0.75        # the JAX heads' pre-NMS IoU, which no JAX model sets
TEST_CONF = 0.001     # their proposals' score floor (no effect with minimal_limit = P)


def pure_position_embedding(boxes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(N, 4) xyxy -> (N, 4) log absolute geometry (yolox/utils/box_op.py:84)."""
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
    cy = 0.5 * (boxes[:, 1] + boxes[:, 3])
    return torch.stack([torch.log(torch.abs(cx / width) + 1e-3),
                        torch.log(torch.abs(cy / height) + 1e-3),
                        torch.log(w / width), torch.log(h / height)], -1)


def iou_window_mask(N: int, lframe: int, p: int, window: int,
                    device=None) -> torch.Tensor:
    """(N, N) frame-window visibility of iou_base aggregation
    (SelfAttentionLocal:128-136): query row q of frame fq sees key k of
    frame fk iff max(fk - window, 0) <= fq < min(fk + window, lframe)."""
    frame = torch.arange(N, device=device) // p
    fq, fk = frame[:, None], frame[None, :]
    return (fq >= (fk - window).clamp(min=0)) & (fq < (fk + window).clamp(max=lframe))


class SelfAttentionLocal(nn.Module):
    """SelfAttentionLocal (post_trans.py:47; yolov_heads.py:67-194):
    scaled dot-product attention (head_dim ** -0.5, no normalisation of q
    and k) with a box-relation branch, its options as JAX's fields.
    `loc2feature` is the reference's 1x1 conv of the 64-dim relation
    embedding to a bias a head (weight (h, 64, 1, 1); JAX applies it as a
    Dense), or with `pure_pos_emb` its Linear(4, C) of the absolute
    geometry, added to the input features. With `reconf`, q and k come from
    the first half of qk(cat[x_cls, x_reg]) (2C -> 4C; chunks 2 and 3 unused,
    as in the reference) and the outputs are flattened in the reference's
    (head, token, dim) order, a layout scramble that its checkpoints are
    trained against (:174-190)."""

    def __init__(self, dim: int, num_heads: int = 4, reconf: bool = False,
                 use_time_emd: bool = False, use_loc_emb: bool = True,
                 loc_fuse_type: str = "add", pure_pos_emb: bool = False,
                 loc_conf: bool = False, iou_base: bool = False, iou_window: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if loc_fuse_type not in ("add", "dot", "identity"):
            raise ValueError(f"loc_fuse_type {loc_fuse_type!r}: 'add', 'dot' or 'identity'")
        self.num_heads = num_heads
        self.reconf = reconf
        self.loc_conf = loc_conf
        self.iou_base = iou_base
        self.iou_window = iou_window
        self.use_loc = use_loc_emb and not iou_base
        self.use_pure = pure_pos_emb and not iou_base
        self.use_time = use_time_emd and not iou_base
        self.fuse = "identity" if (self.use_pure or iou_base) else loc_fuse_type
        if self.fuse != "identity" and not self.use_loc:
            # JAX's module reads a relation bias it never made here (a TypeError)
            raise ValueError(f"loc_fuse_type {loc_fuse_type!r} needs use_loc_emb")
        if self.use_loc and not self.use_pure:
            self.loc2feature = nn.Conv2d(64, num_heads, 1, dtype=dtype)
        elif self.use_pure:
            self.loc2feature = nn.Linear(4, dim, bias=False, dtype=dtype)
        if reconf:
            self.qk = nn.Linear(2 * dim, 4 * dim, bias=False, dtype=dtype)
            self.v_cls = nn.Linear(dim, dim, bias=False, dtype=dtype)
            self.v_reg = nn.Linear(dim, dim, bias=False, dtype=dtype)
        else:
            self.qkv = nn.Linear(dim, 3 * dim, bias=False, dtype=dtype)

    def forward(self, x_cls: torch.Tensor, x_reg: torch.Tensor, boxes: torch.Tensor,
                cls_score: torch.Tensor, fg_score: torch.Tensor, valid: torch.Tensor,
                lframe: int, p: int, width: int = 576, height: int = 576
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x_* (N, C), boxes (N, 4) xyxy, scores and valid (N,); N = F x p."""
        N, C = x_cls.shape
        h = self.num_heads
        dt = x_cls.dtype
        f32 = torch.promote_types(dt, torch.float32)    # fp32 (float64 runs stay so)
        attn_lt = None
        if self.use_loc and not self.use_pure:
            loc_emd = extract_position_embedding(extract_position_matrix(boxes, boxes), 64)
            if self.use_time:
                te = torch.as_tensor(get_timing_signal_1d(np.arange(N // p), 64),
                                     device=boxes.device)
                # the reference tiles (LF, 1, 64).repeat(P, N, 1): query row
                # q gets frame q % LF, not q // P (post_trans.py:105-107)
                loc_emd = loc_emd + te[torch.arange(N, device=boxes.device) % (N // p)][:, None]
            w = self.loc2feature
            attn_lt = F.linear(loc_emd.to(dt), w.weight[:, :, 0, 0], w.bias)
            attn_lt = torch.relu(attn_lt.to(f32)).permute(2, 0, 1)       # (h, N, N)
            if self.loc_conf:
                attn_lt = attn_lt * (fg_score > 0.001).to(f32)[None, None, :]
        elif self.use_pure:
            add = self.loc2feature(pure_position_embedding(boxes.to(f32), width, height).to(dt))
            if self.use_time:
                te = torch.as_tensor(get_timing_signal_1d(np.arange(N // p), C),
                                     device=boxes.device)
                add = add + te[torch.arange(N, device=boxes.device) // p]
            x_cls = x_cls + add

        if self.reconf:
            q, k = self.qk(torch.cat([x_cls, x_reg], -1)).chunk(4, -1)[:2]
            v_cls, v_reg = self.v_cls(x_cls), self.v_reg(x_reg)
        else:
            q, k, v_cls = self.qkv(x_cls).chunk(3, -1)
            v_reg = None

        qh, kh = (_split_heads(t[None], h)[0] for t in (q, k))          # (h, N, d)
        logits = torch.einsum("hqd,hkd->hqk", qh.to(f32), kh.to(f32)) * (C // h) ** -0.5
        if self.loc_conf and cls_score is not None:
            logits = logits * cls_score.to(f32)[None, None, :]
        if self.fuse == "add":
            logits = logits + torch.log(attn_lt + 1e-6)
        elif self.fuse == "dot":
            logits = logits * torch.log(attn_lt + 1e-6)
        kmask = torch.where(valid, 0.0, NEG).to(f32)[None, None, :]
        attn = torch.softmax(logits + kmask, -1)

        if self.iou_base:
            win = (iou_window_mask(N, lframe, p, self.iou_window, boxes.device)
                   if self.iou_window != 0 else True)
            iou_mat = ((pairwise_iou_xyxy(boxes, boxes) > 0.0) & win & valid[None, :]).to(f32)
            attn = attn * iou_mat[None]
            attn = attn / attn.sum(-1, keepdim=True).clamp(min=1e-12)

        def heads_out(v):
            return torch.einsum("hqk,hkd->hqd", attn, _split_heads(v[None], h)[0].to(f32))

        if self.reconf:
            # (h, N, d) flattened as it lies: the reference's scramble
            return (heads_out(v_cls).reshape(N, C).to(dt),
                    heads_out(v_reg).reshape(N, C).to(dt))
        return _merge_heads(heads_out(v_cls)[None])[0].to(dt), None


class LocalFFN(nn.Module):
    """FFN (post_trans.py:184): Linear -> exact GELU -> Linear, under the
    reference's `net` Sequential (its dropouts are 0: identities here)."""

    def __init__(self, dim: int, hidden_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(dim * hidden_ratio)
        self.net = nn.Sequential(nn.Linear(dim, hidden, dtype=dtype), nn.GELU(), nn.Identity(),
                                 nn.Linear(hidden, dim, dtype=dtype), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerBlockLocal(nn.Module):
    """TransformerBlock (post_trans.py:199; yolov_heads.py:212-258):
    pre-norm attention with residuals, LayerNorms in fp32 with eps 1e-6
    (flax's); with `reconf` separate cls and reg residual and FFN
    streams (norm4, mlp_conf). norm3 normalises the reg input whether or
    not the attention reads it, as in JAX."""

    def __init__(self, dim: int, num_heads: int = 4, reconf: bool = False,
                 use_ffn: bool = True, dtype: torch.dtype = torch.float32, **attn_kw):
        super().__init__()
        self.reconf = reconf
        self.use_ffn = use_ffn
        self.self_attn = SelfAttentionLocal(dim, num_heads, reconf, dtype=dtype, **attn_kw)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        if use_ffn:
            self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
            self.mlp = LocalFFN(dim, dtype=dtype)
            if reconf:
                self.norm4 = nn.LayerNorm(dim, eps=LN_EPS)
                self.mlp_conf = LocalFFN(dim, dtype=dtype)

    def forward(self, x_cls, x_reg, boxes, cls_score, fg_score, valid, lframe, p,
                width=576, height=576):
        a_cls, a_reg = self.self_attn(_layer_norm(self.norm1, x_cls),
                                      _layer_norm(self.norm3, x_reg), boxes, cls_score,
                                      fg_score, valid, lframe, p, width, height)
        x_cls = x_cls + a_cls
        if self.reconf:
            x_reg = x_reg + a_reg
        if self.use_ffn:
            x_cls = x_cls + self.mlp(_layer_norm(self.norm2, x_cls))
            if self.reconf:
                x_reg = x_reg + self.mlp_conf(_layer_norm(self.norm4, x_reg))
        return x_cls, x_reg


class LocalAggregation(nn.Module):
    """LocalAggregation (post_trans.py:972): `blocks` TransformerBlockLocal
    layers (`transBlocks.i`) over every proposal of the window; the
    features stay C wide. Without `reconf` the reg features pass through
    untouched."""

    def __init__(self, dim: int, num_heads: int = 4, blocks: int = 1, reconf: bool = False,
                 use_ffn: bool = True, use_time_emd: bool = False, use_loc_emb: bool = True,
                 loc_fuse_type: str = "add", pure_pos_emb: bool = False,
                 loc_conf: bool = False, iou_base: bool = False, iou_window: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(use_time_emd=use_time_emd, use_loc_emb=use_loc_emb,
                  loc_fuse_type=loc_fuse_type, pure_pos_emb=pure_pos_emb, loc_conf=loc_conf,
                  iou_base=iou_base, iou_window=iou_window)
        self.transBlocks = nn.ModuleList(
            TransformerBlockLocal(dim, num_heads, reconf, use_ffn, dtype, **kw)
            for _ in range(blocks))

    def forward(self, feat_cls: torch.Tensor, feat_reg: torch.Tensor, boxes: torch.Tensor,
                cls_score: torch.Tensor, fg_score: torch.Tensor, valid: torch.Tensor,
                lframe: int, p: int, width: int = 576, height: int = 576):
        """feat_* (N, C) flattened across frames (N = F x p); boxes (N, 4)
        xyxy. Returns (cls (N, C), reg (N, C))."""
        x_cls, x_reg = feat_cls, feat_reg
        for block in self.transBlocks:
            x_cls, x_reg = block(x_cls, x_reg, boxes, cls_score, fg_score, valid, lframe, p,
                                 width, height)
        return x_cls, x_reg


class _VideoTowers(nn.Module):
    """The per-level stems, still towers and preds and the video towers
    of the YOLOV heads (yolov_heads.py:299-367), built as attributes of
    the head so that the names are the reference's (`stems.0`,
    `cls_convs2.0.1`; JAX nests them under `towers`). The cls video tower
    always runs; the reg video tower only with `vid_reg` (YOLOV++), else
    the still reg tower's maps stand in."""

    def __init__(self, num_classes: int, width: float, in_channels: Sequence[int],
                 act: str, depthwise: bool, vid_reg: bool, dtype: torch.dtype):
        super().__init__()
        self.num_classes = num_classes
        self.hidden = hidden = int(256 * width)
        self.vid_reg = vid_reg
        Conv = conv_cls(depthwise)
        n = len(in_channels)
        kw = dict(act=act, dtype=dtype)

        def towers():
            return nn.ModuleList(nn.Sequential(Conv(hidden, hidden, 3, 1, **kw),
                                               Conv(hidden, hidden, 3, 1, **kw))
                                 for _ in range(n))

        self.stems = nn.ModuleList(BaseConv(int(c * width), hidden, 1, 1, **kw)
                                   for c in in_channels)
        self.cls_convs, self.reg_convs = towers(), towers()
        self.cls_preds = nn.ModuleList(nn.Conv2d(hidden, num_classes, 1, dtype=dtype)
                                       for _ in range(n))
        self.reg_preds = nn.ModuleList(nn.Conv2d(hidden, 4, 1, dtype=dtype) for _ in range(n))
        self.obj_preds = nn.ModuleList(nn.Conv2d(hidden, 1, 1, dtype=dtype) for _ in range(n))
        self.cls_convs2 = towers()
        if vid_reg:
            self.reg_convs2 = towers()

    def dense(self, xin: Sequence[torch.Tensor], stats: Optional[BNStats]):
        """(raw outputs (F, A, 5 + C), hw, cls video features (F, A, hid),
        reg video features (F, A, hid)) of the FPN maps (F, c, h, w)."""
        levels, hw, cls_vid, reg_vid = [], [], [], []
        for k, x in enumerate(xin):
            hw.append((x.shape[2], x.shape[3]))
            x = self.stems[k](x, stats)
            cls_f = run(self.cls_convs[k], x, stats)
            reg_f = run(self.reg_convs[k], x, stats)
            levels.append(torch.cat([self.reg_preds[k](reg_f), self.obj_preds[k](reg_f),
                                     self.cls_preds[k](cls_f)], 1))
            cls_vid.append(run(self.cls_convs2[k], x, stats))
            reg_vid.append(run(self.reg_convs2[k], x, stats) if self.vid_reg else reg_f)
        return (flatten_levels(levels), hw, flatten_levels(cls_vid), flatten_levels(reg_vid))

    def select(self, raw_outputs: torch.Tensor, hw, strides, p: int, use_pre_nms: bool
               ) -> Tuple[torch.Tensor, FrameProposals]:
        """The decoded rows (F, A, 5 + C), obj and classes sigmoided, and
        the fixed-P proposals from the detached decode: every slot valid
        (minimal_limit = P, as JAX's heads pass it), or with the pre-NMS
        (IoU 0.75, the JAX heads' `pre_nms`) the slots that survived it."""
        dec = decode_outputs(raw_outputs.to(torch.float32), hw, strides)
        decoded = torch.cat([dec[..., :4], torch.sigmoid(dec[..., 4:])], -1)
        props = select_frame_proposals(decoded.detach(), self.num_classes, p, TEST_CONF, p,
                                       PRE_NMS, use_pre_nms)
        return decoded, props


class YOLOVHead(_VideoTowers):
    """YOLOV head (yolovp_msa.py:22; yolov_heads.py:370-441), the fields
    JAX's model sets (the others at their defaults: score guidance on, no
    score-window mask, conf_sim_thresh 0.99): dense
    YOLOX preds per frame, fixed-P proposals (by default through the
    pre-NMS: top 750 by objectness, class-aware NMS at 0.75), MSA
    self-attention over every frame's proposals at once, refined cls
    logits (F, P, C) and with `reconf` obj logits (F, P)."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False, heads: int = 4, num_proposals: int = 30,
                 sim_thresh: float = 0.75, use_pre_nms: bool = True, reconf: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, width, in_channels, act, depthwise, False, dtype)
        self.strides = tuple(strides)
        self.num_proposals = num_proposals
        self.sim_thresh = sim_thresh
        self.use_pre_nms = use_pre_nms
        self.reconf = reconf
        hid = self.hidden
        self.agg = MSAYolov(hid, 4 * hid, heads, reconf=reconf, dtype=dtype)
        self.cls_pred = nn.Linear(4 * hid, num_classes, dtype=dtype)
        if reconf:
            self.obj_pred = nn.Linear(4 * hid, 1, dtype=dtype)

    def forward(self, xin: Sequence[torch.Tensor], lframe: int = 0, gframe: int = 16,
                stats: Optional[BNStats] = None) -> Dict[str, Any]:
        """xin: 3 FPN levels (F, c, h, w); `stats` the BN mode. Every
        frame is refined (JAX's head reads neither lframe nor gframe)."""
        P, hid = self.num_proposals, self.hidden
        raw, hw, cls_feat, reg_feat = self.dense(xin, stats)
        decoded, props = self.select(raw, hw, self.strides, P, self.use_pre_nms)
        F_ = props.boxes.shape[0]
        f_cls = _gather_rows(cls_feat, props.idx).reshape(-1, hid)
        f_reg = _gather_rows(reg_feat, props.idx).reshape(-1, hid)
        agg_cls, agg_obj = self.agg(f_cls, f_reg, props.cls_conf.reshape(-1),
                                    props.obj.reshape(-1), props.valid.reshape(-1),
                                    sim_thresh=self.sim_thresh)
        out: Dict[str, Any] = {"raw_outputs": raw, "hw": hw, "decoded": decoded,
                               "proposals": props,
                               "refined_cls_logits": self.cls_pred(agg_cls).reshape(F_, P, -1)}
        if self.reconf:
            out["refined_obj_logits"] = self.obj_pred(agg_obj).reshape(F_, P)
        return out


class YOLOVPlusHead(_VideoTowers):
    """YOLOV++ head (v_plus_head.py:24; yolov_heads.py:444-581), the fields
    JAX's model sets (the others, localagg's options too, at their
    defaults): `agg_type` "mca" | "msa" | "localagg", and
    `decouple_reg`, a second aggregator (`agg_iou`, reconf) for the obj
    features under msa and mca. Refined rows: the first L = max(lframe, 1)
    frames, or all F with lframe 0 (:502)."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False, heads: int = 4, num_proposals: int = 30,
                 sim_thresh: float = 0.75, use_pre_nms: bool = False, reconf: bool = True,
                 decouple_reg: bool = True, agg_type: str = "mca",
                 conf_sim_thresh: float = 0.99, dtype: torch.dtype = torch.float32):
        super().__init__(num_classes, width, in_channels, act, depthwise, True, dtype)
        if agg_type not in ("mca", "msa", "localagg"):
            raise ValueError(f"agg_type {agg_type!r}: 'mca', 'msa' or 'localagg'")
        self.strides = tuple(strides)
        self.num_proposals = num_proposals
        self.sim_thresh = sim_thresh
        self.use_pre_nms = use_pre_nms
        self.reconf = reconf
        self.decouple_reg = decouple_reg
        self.agg_type = agg_type
        self.conf_sim_thresh = conf_sim_thresh
        hid = self.hidden
        if agg_type == "localagg":
            # JAX's model passes none of the head's localagg options: their defaults
            self.agg = LocalAggregation(hid, heads, reconf=reconf, dtype=dtype)
            width_out = hid
        elif agg_type == "msa":
            self.agg = MSAYolov(hid, 4 * hid, heads, reconf=reconf, dtype=dtype)
            if decouple_reg:
                self.agg_iou = MSAYolov(hid, 4 * hid, heads, reconf=True, dtype=dtype)
            width_out = 4 * hid
        else:
            self.agg = MCAg2l(hid, 4 * hid, heads, reconf=False, dtype=dtype)
            if decouple_reg:
                self.agg_iou = MCAg2l(hid, 4 * hid, heads, reconf=True, dtype=dtype)
            width_out = 4 * hid
        self.cls_pred = nn.Linear(width_out, num_classes, dtype=dtype)
        # the obj head exists where JAX's head reaches it (:578): reconf
        # with obj features, which mca gets only from agg_iou
        self.has_obj = reconf and (agg_type != "mca" or decouple_reg)
        if self.has_obj:
            self.obj_pred = nn.Linear(width_out, 1, dtype=dtype)

    def forward(self, xin: Sequence[torch.Tensor], lframe: int, gframe: int,
                time_embedding: Optional[torch.Tensor] = None,
                stats: Optional[BNStats] = None) -> Dict[str, Any]:
        """xin: 3 FPN levels (F, c, h, w), frames [local..., global...];
        the time embedding is taken and not read, as in JAX."""
        P, hid = self.num_proposals, self.hidden
        raw, hw, cls_feat, reg_feat = self.dense(xin, stats)
        decoded, props = self.select(raw, hw, self.strides, P, self.use_pre_nms)
        F_ = props.boxes.shape[0]
        f_cls = _gather_rows(cls_feat, props.idx)                       # (F, P, hid)
        f_reg = _gather_rows(reg_feat, props.idx)
        L = max(lframe, 1) if lframe > 0 else F_
        cs, fs = props.cls_conf, props.obj
        out: Dict[str, Any] = {"raw_outputs": raw, "hw": hw, "decoded": decoded,
                               "proposals": props}
        kw = dict(sim_thresh=self.sim_thresh, conf_sim_thresh=self.conf_sim_thresh)
        flat = (f_cls.reshape(-1, hid), f_reg.reshape(-1, hid))
        if self.agg_type == "localagg":
            x0 = xin[0]
            agg_cls, agg_obj = self.agg(*flat, props.boxes.reshape(-1, 4), cs.reshape(-1),
                                        fs.reshape(-1), props.valid.reshape(-1), F_, P,
                                        x0.shape[3] * self.strides[0],
                                        x0.shape[2] * self.strides[0])
            agg_cls = agg_cls.reshape(F_, P, -1)[:L]
            agg_obj = agg_obj.reshape(F_, P, -1)[:L]
        elif self.agg_type == "msa":
            agg_cls, agg_obj = self.agg(*flat, cs.reshape(-1), fs.reshape(-1),
                                        props.valid.reshape(-1), obj=not self.decouple_reg,
                                        **kw)
            if self.decouple_reg:
                # the obj features from the second aggregator (v_plus_head.py:418-421)
                _, agg_obj = self.agg_iou(*flat, cs.reshape(-1), fs.reshape(-1),
                                          props.valid.reshape(-1), **kw)
            agg_cls = agg_cls.reshape(F_, P, -1)[:L]
            agg_obj = agg_obj.reshape(F_, P, -1)[:L] if agg_obj is not None else None
        else:
            agg_cls, _ = self.agg(f_cls, f_reg, cs, fs, props.valid, L, **kw)
            agg_obj = (self.agg_iou(f_cls, f_reg, cs, fs, props.valid, L, **kw)[1]
                       if self.decouple_reg else None)
        out["refined_cls_logits"] = self.cls_pred(agg_cls)
        if self.has_obj:
            out["refined_obj_logits"] = self.obj_pred(agg_obj)[..., 0]
        return out


class OnlineBank(NamedTuple):
    """The online head's rolling proposal banks (yolov_heads.py:584-614:
    the reference's `other_result` and the demo's local bank as fixed
    FIFOs): the MAIN bank of past frames' proposal features and scores,
    and the LOCAL bank of past frames' MSA outputs and boxes, each a ring
    buffer with its write pointer; `frames` counts the frames pushed. The
    same 13 fields and dtypes as JAX's (int32 scalars as 0-d tensors)."""
    cls_feat: torch.Tensor     # (B, h)
    reg_feat: torch.Tensor     # (B, h)
    cls_score: torch.Tensor    # (B,)
    fg_score: torch.Tensor     # (B,)
    valid: torch.Tensor        # (B,) bool
    ptr: torch.Tensor          # () int32: the next write slot
    msa_feat: torch.Tensor     # (Bl, 4h) MSA outputs of past frames
    boxes: torch.Tensor        # (Bl, 4) xyxy
    l_cls_score: torch.Tensor  # (Bl,)
    l_fg_score: torch.Tensor   # (Bl,)
    l_valid: torch.Tensor      # (Bl,) bool
    l_ptr: torch.Tensor        # () int32
    frames: torch.Tensor       # () int32: frames pushed so far


def init_online_bank(capacity: int, hidden: int, device=None) -> OnlineBank:
    """An empty fp32 bank (yolov_heads.py:617-629) on `device`: `capacity`
    main slots of `hidden` features and as many local slots of 4 x
    `hidden`, as the demo sizes it."""
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    n, i32, b = capacity, torch.int32, torch.bool
    return OnlineBank(z(n, hidden), z(n, hidden), z(n), z(n), z(n, dt=b), z(dt=i32),
                      z(n, 4 * hidden), z(n, 4), z(n), z(n), z(n, dt=b), z(dt=i32), z(dt=i32))


def _ring_slots(ptr: torch.Tensor, n: int, size: int) -> torch.Tensor:
    return (ptr + torch.arange(n, device=ptr.device)) % size


def bank_push(bank: OnlineBank, cls_feat: torch.Tensor, reg_feat: torch.Tensor,
              cls_score: torch.Tensor, fg_score: torch.Tensor,
              valid: torch.Tensor) -> OnlineBank:
    """One frame's P proposals into the MAIN bank's ring at its pointer
    (yolov_heads.py:632-651): the pointer moves P slots, `frames` one."""
    idx = _ring_slots(bank.ptr, cls_feat.shape[0], bank.cls_feat.shape[0])

    def put(buf, new):
        return buf.index_copy(0, idx, new.to(buf.dtype))

    return bank._replace(
        cls_feat=put(bank.cls_feat, cls_feat), reg_feat=put(bank.reg_feat, reg_feat),
        cls_score=put(bank.cls_score, cls_score), fg_score=put(bank.fg_score, fg_score),
        valid=put(bank.valid, valid),
        ptr=(bank.ptr + cls_feat.shape[0]) % bank.cls_feat.shape[0],
        frames=bank.frames + 1)


def bank_push_local(bank: OnlineBank, msa: torch.Tensor, boxes: torch.Tensor,
                    cls_score: torch.Tensor, fg_score: torch.Tensor, valid: torch.Tensor,
                    ran: torch.Tensor) -> OnlineBank:
    """The LOCAL bank's insert where `ran` (a 0-d bool: the MSA ran on a
    bank this step), else the bank unchanged (yolov_heads.py:654-672): the
    choice is made on the device."""
    n, size = msa.shape[0], bank.msa_feat.shape[0]
    idx = _ring_slots(bank.l_ptr, n, size)

    def put(buf, new):
        return torch.where(ran, buf.index_copy(0, idx, new.to(buf.dtype)), buf)

    return bank._replace(
        msa_feat=put(bank.msa_feat, msa), boxes=put(bank.boxes, boxes),
        l_cls_score=put(bank.l_cls_score, cls_score),
        l_fg_score=put(bank.l_fg_score, fg_score), l_valid=put(bank.l_valid, valid),
        l_ptr=torch.where(ran, (bank.l_ptr + n) % size, bank.l_ptr))


def local_agg_merge(features: torch.Tensor, boxes: torch.Tensor, cls_score: torch.Tensor,
                    fg_score: torch.Tensor, local_feat: torch.Tensor,
                    local_boxes: torch.Tensor, l_cls_score: torch.Tensor,
                    l_fg_score: torch.Tensor, l_valid: torch.Tensor) -> torch.Tensor:
    """MSA_yolov_online.local_agg (post_trans.py:1324-1345;
    yolov_heads.py:675-713): the current frame's features (P, D) merged
    with the local bank's by softmax(25 cos-sim x score-threshold map) x
    box IoU, rows normalised, then averaged with the input. The threshold
    map zeroes logits (not -inf); invalid bank slots leave the softmax; a
    row that overlaps no bank box keeps its own features (JAX's guard of
    the reference's unguarded division)."""
    f32 = torch.float32
    feats = features.to(f32)
    cos = _l2norm(feats) @ _l2norm(local_feat.to(f32)).T               # (P, M)
    iou = pairwise_iou_xyxy(boxes.to(f32), local_boxes.to(f32))
    pre = (cls_score * fg_score).to(f32)[:, None]
    other = (l_cls_score * l_fg_score).to(f32)[None, :]
    thresh = ((other - pre) > -0.3).to(f32)
    logits = torch.where(l_valid[None, :], 25.0 * cos * thresh, NEG)
    w = torch.softmax(logits, -1) * iou * l_valid[None, :].to(f32)
    row_sum = w.sum(-1, keepdim=True)
    w = w / row_sum.clamp(min=1e-12)
    merged = torch.where(row_sum > 1e-8, w @ local_feat.to(f32), feats)
    return ((merged + feats) * 0.5).to(features.dtype)


class YOLOVOnlineHead(_VideoTowers):
    """The streaming YOLOV head (yolov_heads.py:716-796; reference
    yolov_msa_online.py:27), the fields JAX's model sets, in fp32 with
    strides (8, 16, 32): ONE frame a call (xin: 3 FPN levels (1, c, h,
    w)); its P proposals (always through the pre-NMS, the head's default)
    and the square MSA over [current ++ main
    bank] (MSA_yolov_online: `trans`, reg logits guided by the fg score;
    the bank's rows join only from the third frame on, `use_refined` =
    bank.frames >= 2, as the reference takes the still result until two
    frames are banked), `cur` its first P rows, merged against the local
    bank where it holds any row, then `cls_pred`. The refined logits are
    computed every call (one fixed program); the new bank comes back in
    out["bank"]."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False, heads: int = 4, num_proposals: int = 30,
                 sim_thresh: float = 0.75):
        super().__init__(num_classes, width, in_channels, act, depthwise, False,
                         torch.float32)
        self.num_proposals = num_proposals
        self.sim_thresh = sim_thresh
        hid = self.hidden
        self.trans = MSAYolov(hid, 4 * hid, heads, reg_score_guidance=True)
        self.cls_pred = nn.Linear(4 * hid, num_classes)

    def forward(self, xin: Sequence[torch.Tensor], bank: OnlineBank,
                stats: Optional[BNStats] = None) -> Dict[str, Any]:
        P = self.num_proposals
        raw, hw, cls_feat, reg_feat = self.dense(xin, stats)
        decoded, props = self.select(raw, hw, (8, 16, 32), P, True)
        f_cls = _gather_rows(cls_feat, props.idx)[0]                  # (P, hid)
        f_reg = _gather_rows(reg_feat, props.idx)[0]
        cs, fs, vl, boxes = props.cls_conf[0], props.obj[0], props.valid[0], props.boxes[0]
        ran = bank.frames >= 2
        cat = lambda cur, old: torch.cat([cur, old.to(cur.dtype)], 0)   # noqa: E731
        out, _ = self.trans(cat(f_cls, bank.cls_feat), cat(f_reg, bank.reg_feat),
                            cat(cs, bank.cls_score), cat(fs, bank.fg_score),
                            torch.cat([vl, bank.valid & ran], 0), sim_thresh=self.sim_thresh)
        cur = out[:P]                                                 # (P, 4 hid)
        merged = local_agg_merge(cur, boxes, cs, fs, bank.msa_feat, bank.boxes,
                                 bank.l_cls_score, bank.l_fg_score, bank.l_valid)
        refined = self.cls_pred(torch.where(bank.l_valid.any(), merged, cur))
        new_bank = bank_push(bank, f_cls, f_reg, cs, fs, vl)
        new_bank = bank_push_local(new_bank, cur, boxes, cs, fs, vl & ran, ran)
        return {"raw_outputs": raw, "hw": hw, "decoded": decoded, "proposals": props,
                "refined_cls_logits": refined[None], "use_refined": ran, "bank": new_bank}
