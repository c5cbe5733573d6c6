"""YOLO PAFPN neck (counterpart of tscd_tpu/models/pafpn.py; reference
yolo_pafpn.py:12): CSPDarknet + top-down FPN + bottom-up PAN. Outputs
(pan_out2 stride 8, pan_out1 stride 16, pan_out0 stride 32), NCHW."""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, BNStats, CSPLayer, conv_cls
from .darknet import CSPDarknet


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        self.dtype = dtype
        Conv = conv_cls(depthwise)
        c0, c1, c2 = (int(c * width) for c in in_channels)
        n = round(3 * depth)
        kw = dict(act=act, dtype=dtype)
        self.backbone = CSPDarknet(depth, width, in_features, depthwise, **kw)
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, **kw)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False, depthwise=depthwise, **kw)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, **kw)
        self.C3_p3 = CSPLayer(2 * c0, c0, n, False, depthwise=depthwise, **kw)
        self.bu_conv2 = Conv(c0, c0, 3, 2, **kw)
        self.C3_n3 = CSPLayer(2 * c0, c1, n, False, depthwise=depthwise, **kw)
        self.bu_conv1 = Conv(c1, c1, 3, 2, **kw)
        self.C3_n4 = CSPLayer(2 * c1, c2, n, False, depthwise=depthwise, **kw)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (F, H, W, 3) image, NHWC; `stats` the BN mode
        (`blocks.batch_norm`). At fp32, uint8 is cast to fp32 exactly; at
        bf16 the stem reads uint8 frames itself."""
        if x.dtype == torch.uint8 and self.dtype == torch.float32:
            x = x.to(torch.float32)
        feats = self.backbone(x, stats)
        x2, x1, x0 = (feats[f] for f in self.in_features)
        fpn_out0 = self.lateral_conv0(x0, stats)
        f_out0 = self.C3_p4(torch.cat([upsample2x(fpn_out0), x1], 1), stats)
        fpn_out1 = self.reduce_conv1(f_out0, stats)
        pan_out2 = self.C3_p3(torch.cat([upsample2x(fpn_out1), x2], 1), stats)
        p_out1 = self.bu_conv2(pan_out2, stats)
        pan_out1 = self.C3_n3(torch.cat([p_out1, fpn_out1], 1), stats)
        p_out0 = self.bu_conv1(pan_out1, stats)
        pan_out0 = self.C3_n4(torch.cat([p_out0, fpn_out0], 1), stats)
        return pan_out2, pan_out1, pan_out0


def build_pafpn_backbone(name: str, depth: float, width: float,
                         act: str = "silu", depthwise: bool = False,
                         dtype: torch.dtype = torch.float32) -> nn.Module:
    """Exp `backbone_name` -> feature pyramid. Only the CSPDarknet
    PAFPN ("MCSP") is ported so far."""
    if name in ("MCSP", "mcsp", None, ""):
        return YOLOPAFPN(depth, width, act=act, depthwise=depthwise,
                         dtype=dtype)
    raise NotImplementedError(f"backbone {name!r} is not ported yet")
