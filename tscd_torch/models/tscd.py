"""TSCD top model (counterpart of tscd_tpu/models/tscd.py; reference
yolox/models/tscd.py:11): YOLOPAFPN + TSCDHead over a frame window, eval
forward only, plus the final eval postprocess."""

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..ops.postprocess import (Detections, postprocess_best_class,
                               postprocess_refined)
from .matching import MatcherState
from .pafpn import build_pafpn_backbone
from .tscd_head import TSCDHead


class TSCD(nn.Module):
    """Eval-mode TSCD on the TSCD-Large path (MCA aggregation, decoupled
    reg, reconf heads, top-k proposals). Built on `device`, the card
    unless the caller passes another; random init from the default torch
    initialisers until weights are loaded (see `random_init_`)."""

    def __init__(self, num_classes: int = 30, depth: float = 1.0,
                 width: float = 1.0, act: str = "silu",
                 depthwise: bool = False, num_proposals: int = 50,
                 minimal_limit: Optional[int] = None, heads: int = 4,
                 decoder_layer_num: int = 1, sim_thresh: float = 0.75,
                 conf_sim_thresh: float = 0.99, test_conf: float = 0.001,
                 backbone_name: str = "MCSP",
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.backbone = build_pafpn_backbone(backbone_name, depth, width,
                                             act=act, depthwise=depthwise)
        self.head = TSCDHead(
            num_classes, width=width, act=act, depthwise=depthwise,
            heads=heads, decoder_layer_num=decoder_layer_num,
            num_proposals=num_proposals, minimal_limit=minimal_limit,
            sim_thresh=sim_thresh, conf_sim_thresh=conf_sim_thresh,
            test_conf=test_conf)
        self.to(device)
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("the port runs the eval forward only")
        return super().train(False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x: torch.Tensor, time_embedding: torch.Tensor,
                lframe: int, gframe: int,
                matcher_state: Optional[MatcherState] = None
                ) -> Dict[str, Any]:
        """x: (F, H, W, 3) frame window [local..., global...] (F =
        lframe + gframe, H and W multiples of 32); time_embedding:
        (F, 256). Returns the head's dict; thread
        out["matcher_state"] into the next window."""
        if x.shape[0] != lframe + gframe:
            raise ValueError(f"{x.shape[0]} frames != {lframe} + {gframe}")
        with torch.no_grad():
            fpn_outs = self.backbone(x)
            return self.head(fpn_outs, time_embedding, lframe,
                             matcher_state=matcher_state)


def tscd_eval_postprocess(head_out: Dict[str, Any], lframe: int,
                          num_classes: int, nms_thresh: float = 0.5,
                          conf_thre: float = 0.001, out_k: int = 100
                          ) -> Tuple[Detections, Detections]:
    """Final eval postprocess (reference tscd_head.py:726 ->
    post_process.py:9): per local frame, obj = sigmoid(matcher obj),
    class scores = sigmoid(refined cls), boxes = matcher-decoded boxes,
    then class-aware NMS. Returns (refined, original) Detections batched
    over local frames; `original` keeps each proposal's best class."""
    props = head_out["proposals"]
    valid = props.valid[:lframe]
    refined = postprocess_refined(
        head_out["refined_boxes"],
        torch.sigmoid(head_out["matcher_obj_logits"].to(torch.float32)),
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
    identity, the cls/obj prediction biases at the 1e-2 prior. Values are drawn on the CPU from one torch.Generator and then
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
    return model
