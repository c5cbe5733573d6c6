"""YOLOX still-image detector (counterpart of tscd_tpu/models/yolox.py;
reference yolox/models/yolox.py:11): YOLOPAFPN + YOLOXHead, fp32. The
forward returns the raw outputs and, with `decode`, the eval convention
(boxes in pixels, sigmoid on obj and cls); the losses are
`train.losses.yolox_loss` of the raw outputs."""

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..ops.decode import decode_outputs
from .blocks import batch_stats
from .pafpn import YOLOPAFPN
from .yolo_head import YOLOXHead


class StillDetector(nn.Module):
    """The still-image detectors' common frame (YOLOX, YOLOv7, YOLOv8): as
    TSCD, every module stays in torch's eval mode; `train()` only records
    the forward for autograd, and BatchNorm's mode is the forward's `train`
    argument, JAX's."""

    def train(self, mode: bool = True):
        super().train(False)
        self.training = mode
        return self

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _run(self, x: torch.Tensor, train: bool, run) -> Dict[str, Any]:
        """run(x, stats) with `stats` the BN mode, under autograd where the
        model records; with `train` the new running statistics in
        out["batch_stats"] {state_dict key: tensor} (the buffers are left as
        they are)."""
        stats = {} if train else None
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            out = run(x, stats)
        if train:
            out["batch_stats"] = batch_stats(self, stats)
        return out


class YOLOX(StillDetector):
    """Built on `device`, the card unless the caller passes another."""

    def __init__(self, num_classes: int = 80, depth: float = 1.0, width: float = 1.0,
                 act: str = "silu", depthwise: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = YOLOPAFPN(depth, width, act=act, depthwise=depthwise)
        self.head = YOLOXHead(num_classes, width, act=act, depthwise=depthwise)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False, decode: bool = True,
                return_features: bool = False) -> Dict[str, Any]:
        """x: (B, H, W, 3) NHWC, fp32 or uint8, H and W multiples of 32.
        Returns the head's dict and, with `decode`, "decoded" (B, A, 5 + C).
        With `train` every BN normalises with its batch's statistics and
        out["batch_stats"] holds the new running statistics."""
        out = self._run(x, train, lambda x, stats: self.head(
            self.backbone(x, stats), stats, return_features=return_features))
        if decode:
            dec = decode_outputs(out["outputs"].float(), out["hw"], self.head.strides)
            out["decoded"] = torch.cat([dec[..., :4], torch.sigmoid(dec[..., 4:])], -1)
        return out
