"""TSCD top model (counterpart of tscd_tpu/models/tscd.py; reference
yolox/models/tscd.py:11): YOLOPAFPN + TSCDHead over a frame window, plus
the final eval postprocess. The forward is the eval forward; in train
mode it is the stage-2 training forward, which autograd records."""

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.postprocess import (Detections, postprocess_best_class,
                               postprocess_refined)
from .matching import MatcherState
from .pafpn_variants import build_pafpn_backbone
from .swin import WindowAttention
from .tscd_head import TSCDHead


class WindowModel(nn.Module):
    """The feature pyramid the exp's `backbone_name` names (`backbone`,
    `pafpn_variants.build_pafpn_backbone`) and a head over a window of
    frames: the train and BatchNorm rules TSCD and the YOLOV family share.
    Subclasses build their `head` after this builds the backbone, on
    `self.backbone.out_channels` (the pyramid's pre-width channels), then
    `_place` the model on its device."""

    def __init__(self, backbone_name: str, depth: float, width: float, act: str,
                 depthwise: bool, stop_backbone_grad: bool, remat_backbone: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stop_backbone_grad = stop_backbone_grad
        self.remat_backbone = remat_backbone
        self.backbone = build_pafpn_backbone(backbone_name, depth, width, act=act,
                                             depthwise=depthwise, dtype=dtype)

    def _place(self, device: torch.device):
        self.to(device)
        self.eval()

    def train(self, mode: bool = True):
        """Train mode records the forward for autograd; every module stays
        in torch's eval mode: BatchNorm's mode is the forward's `train`
        argument, as in JAX."""
        super().train(False)
        self.training = mode
        return self

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _window(self, x: torch.Tensor, train: bool, head_call) -> Dict[str, Any]:
        """The backbone on x, then head_call(fpn_outs, stats) (`stats` the BN
        mode); with `train` the new running statistics in out["batch_stats"]."""
        stats = {} if train else None
        grad = self.training and torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and not self.stop_backbone_grad):
            if self.remat_backbone and torch.is_grad_enabled():
                fpn_outs = checkpoint(self.backbone, x, stats, use_reentrant=False)
            else:
                fpn_outs = self.backbone(x, stats)
        with torch.set_grad_enabled(grad):
            out = head_call(fpn_outs, stats)
        if train:
            out["batch_stats"] = {
                f"{name}.running_{k}": v for name, bn in self.named_modules()
                if bn in stats for k, v in zip(("mean", "var"), stats[bn])}
        return out


class TSCD(WindowModel):
    """TSCD (tscd.py:20). Built on `device`, the card unless the caller
    passes another; random init from the default torch initialisers until
    weights are loaded (see `random_init_`). The head knobs are the ones
    JAX's TSCD hands to its head (tscd.py:61-76): agg_type, cat_ota_fg,
    reconf, decouple_reg, use_pre_nms, sparse_vid_towers (and the
    proposal and matcher sizes); the head's others (ave, use_mask,
    vid_cls, vid_reg, pre_nms) stay at JAX's defaults here, as JAX's
    TSCD leaves them.

    `dtype` is the compute dtype, as `TSCD.dtype` in JAX (tscd.py:56):
    fp32 or bf16. Conv and Linear weights are stored in it (an fp32
    checkpoint is cast on load); BatchNorm, LayerNorm and the Focus stem
    keep fp32 parameters. At bf16 BN, LayerNorm, attention logits, decode,
    the matcher cost and the postprocess stay fp32, as in JAX. For
    serving, fold BN into the convs with
    `utils.model_utils.fuse_model(model, fp32_state_dict)`.

    `stop_backbone_grad` and `remat_backbone` are JAX's fields of the
    same names (tscd.py:41-52): the first detaches the FPN outputs (the
    backbone's forward is not recorded), the second recomputes the whole
    PAFPN backbone in the backward (`torch.utils.checkpoint`, as
    `nn.remat` wraps it, pafpn_variants.py:199-200)."""

    def __init__(self, num_classes: int = 30, depth: float = 1.0,
                 width: float = 1.0, act: str = "silu",
                 depthwise: bool = False, num_proposals: int = 50,
                 minimal_limit: Optional[int] = None, heads: int = 4,
                 agg_type: str = "mca", cat_ota_fg: bool = False,
                 reconf: bool = True, decouple_reg: bool = True,
                 use_pre_nms: bool = False, sparse_vid_towers: bool = False,
                 decoder_layer_num: int = 1, sim_thresh: float = 0.75,
                 conf_sim_thresh: float = 0.99, test_conf: float = 0.001,
                 backbone_name: str = "MCSP",
                 stop_backbone_grad: bool = False,
                 remat_backbone: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype fp32 or bf16, not {dtype}")
        device = resolve_device(device)
        super().__init__(backbone_name, depth, width, act, depthwise, stop_backbone_grad,
                         remat_backbone, dtype)
        self.num_classes = num_classes
        self.dtype = dtype
        self.head = TSCDHead(
            num_classes, width=width, in_channels=self.backbone.out_channels, act=act,
            depthwise=depthwise, heads=heads, agg_type=agg_type,
            decoder_layer_num=decoder_layer_num, num_proposals=num_proposals,
            minimal_limit=minimal_limit, cat_ota_fg=cat_ota_fg, reconf=reconf,
            decouple_reg=decouple_reg, use_pre_nms=use_pre_nms,
            sim_thresh=sim_thresh, conf_sim_thresh=conf_sim_thresh,
            test_conf=test_conf, sparse_vid_towers=sparse_vid_towers,
            dtype=dtype)
        self._place(device)

    def forward(self, x: torch.Tensor, time_embedding: torch.Tensor,
                lframe: int, gframe: int,
                matcher_state: Optional[MatcherState] = None,
                train: bool = False,
                labels: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """x: (F, H, W, 3) frame window [local..., global...] (F =
        lframe + gframe, H and W multiples of 32), fp32 or uint8;
        time_embedding: (F, 256). Returns the head's dict (raw outputs,
        refined logits and the matcher state in the compute dtype); thread
        out["matcher_state"] into the next window. In train mode, where
        autograd is on, the forward is recorded, the backbone's only
        without `stop_backbone_grad`.

        `train` is JAX's argument of that name, which gates BatchNorm
        only: with it every BN normalises with its batch's statistics, and
        out["batch_stats"] holds the new running statistics
        {state_dict key: tensor} (the model's buffers are left as they
        are; `train.step` writes them). A remat backbone's recompute in
        the backward runs the same BN on the same batch and adds nothing
        to them.

        `labels` (F, G, 5), which the train steps pass (train mode or
        not, as JAX's fix_bn step does), let a cat_ota_fg head inject
        SimOTA's foreground anchors into its proposals."""
        if x.shape[0] != lframe + gframe:
            raise ValueError(f"{x.shape[0]} frames != {lframe} + {gframe}")
        return self._window(x, train, lambda fpn_outs, stats: self.head(
            fpn_outs, time_embedding, lframe, matcher_state=matcher_state, stats=stats,
            labels=labels))


def tscd_eval_postprocess(head_out: Dict[str, Any], lframe: int,
                          num_classes: int, nms_thresh: float = 0.5,
                          conf_thre: float = 0.001, out_k: int = 100
                          ) -> Tuple[Detections, Detections]:
    """Final eval postprocess (reference tscd_head.py:726 ->
    post_process.py:9): per local frame, obj = sigmoid(matcher obj),
    class scores = sigmoid(refined cls), boxes = matcher-decoded boxes,
    then class-aware NMS; a head without the matcher's outputs
    (decouple_reg or reconf off) keeps the proposals' obj and boxes, as
    JAX's (tscd.py:108-116). Returns (refined, original) Detections
    batched over local frames; `original` keeps each proposal's best
    class."""
    props = head_out["proposals"]
    valid = props.valid[:lframe]
    obj = (torch.sigmoid(head_out["matcher_obj_logits"].to(torch.float32))
           if "matcher_obj_logits" in head_out else props.obj[:lframe])
    refined = postprocess_refined(
        head_out.get("refined_boxes", props.boxes[:lframe]), obj,
        torch.sigmoid(head_out["refined_cls_logits"].to(torch.float32)),
        valid, conf_thre, nms_thresh, out_k)
    original = postprocess_best_class(
        props.boxes[:lframe], props.obj[:lframe], props.cls_conf[:lframe],
        props.cls_id[:lframe], valid, conf_thre, nms_thresh, out_k)
    return refined, original


_PRIOR_BIAS = -math.log((1 - 1e-2) / 1e-2)


@torch.no_grad()
def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights close to the JAX package's init scheme (flax
    defaults): conv/linear kernels normal with variance 1/fan_in (flax's
    lecun-normal is also truncated), zero biases, BN and LayerNorm at
    identity, the cls/obj prediction biases at the 1e-2 prior, Swin's
    relative-position tables normal with std 0.02 (flax's is truncated),
    FocalNet's layerscale gammas left at their 1e-4. Values are drawn on the CPU from one torch.Generator and then
    copied, so a model gets the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
            if mod.bias is not None:
                leaf = name.split(".")
                prior = len(leaf) >= 2 and leaf[-2] in ("cls_preds", "obj_preds")
                mod.bias.fill_(_PRIOR_BIAS if prior else 0.0)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
        elif isinstance(mod, nn.LayerNorm):
            mod.reset_parameters()
        elif isinstance(mod, WindowAttention):
            t = mod.relative_position_bias_table
            t.copy_(0.02 * torch.randn(t.shape, generator=gen))
    return model
