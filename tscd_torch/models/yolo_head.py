"""Decoupled YOLOX head (counterpart of tscd_tpu/models/yolo_head.py;
reference yolox/models/yolo_head.py:18), and the level flattening the
video head shares. Outputs per level [reg_x, reg_y, reg_w, reg_h, obj,
cls_0 .. cls_{C-1}] (raw), flattened over the levels in stride order to
(B, A, 5 + C). Label assignment and losses are `ops.simota` and
`train.losses.yolox_loss`."""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import BaseConv, BNStats, conv_cls, run


def flatten_levels(level_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, K, H, W) ...] NCHW -> (B, sum(H*W), K), anchors in raster
    order within each level and levels in stride order: the JAX package
    flattens NHWC, so the maps go to (B, H, W, K) before the reshape."""
    return torch.cat([o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1])
                      for o in level_outputs], 1)


class YOLOXHead(nn.Module):
    """JAX's YOLOXHead (yolo_head.py:29), the reference's state_dict names:
    `stems.k`, `cls_convs.k.i`, `reg_convs.k.i`, `{cls,reg,obj}_preds.k`
    (flax `stem_k`, `cls_conv_k_i`, ...). The cls and obj prediction biases
    start at the prior -log((1 - p) / p), as flax's bias_init sets them.
    `dtype` is the compute dtype (`blocks`), as JAX's field (YOLOv7 runs
    the head at bf16); the maps come in in it."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024), act: str = "silu",
                 depthwise: bool = False, prior_prob: float = 1e-2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        hidden = int(256 * width)
        Conv = conv_cls(depthwise)

        kw = dict(act=act, dtype=dtype)

        def tower():
            return nn.Sequential(Conv(hidden, hidden, 3, 1, **kw),
                                 Conv(hidden, hidden, 3, 1, **kw))

        n = len(in_channels)
        self.stems = nn.ModuleList(BaseConv(int(c * width), hidden, 1, 1, **kw)
                                   for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in range(n))
        self.reg_convs = nn.ModuleList(tower() for _ in range(n))
        pred = lambda c: nn.ModuleList(nn.Conv2d(hidden, c, 1, dtype=dtype)  # noqa: E731
                                       for _ in range(n))
        self.cls_preds, self.reg_preds, self.obj_preds = pred(num_classes), pred(4), pred(1)
        prior = -math.log((1 - prior_prob) / prior_prob)
        with torch.no_grad():
            for m in (*self.cls_preds, *self.obj_preds):
                m.bias.fill_(prior)

    def forward(self, xin: Sequence[torch.Tensor], stats: Optional[BNStats] = None,
                return_features: bool = False):
        """xin: the FPN's maps (NCHW, stride order); `stats` the BN mode
        (`blocks.batch_norm`). Returns {"outputs": (B, A, 5 + C) raw, "hw":
        [(H, W)] a level} and, with `return_features`, the towers' "cls_feat"
        and "reg_feat" (B, A, hidden)."""
        levels, cls_feats, reg_feats, hw = [], [], [], []
        for k, x in enumerate(xin):
            hw.append((x.shape[2], x.shape[3]))
            x = self.stems[k](x, stats)
            cls_f = run(self.cls_convs[k], x, stats)
            reg_f = run(self.reg_convs[k], x, stats)
            levels.append(torch.cat([self.reg_preds[k](reg_f), self.obj_preds[k](reg_f),
                                     self.cls_preds[k](cls_f)], 1))
            if return_features:
                cls_feats.append(cls_f)
                reg_feats.append(reg_f)
        out = {"outputs": flatten_levels(levels), "hw": hw}
        if return_features:
            out["cls_feat"] = flatten_levels(cls_feats)
            out["reg_feat"] = flatten_levels(reg_feats)
        return out
