"""YOLO PAFPN neck (counterpart of tscd_tpu/models/pafpn.py; reference
yolo_pafpn.py:12): a backbone network + top-down FPN + bottom-up PAN.
Outputs (pan_out2 stride 8, pan_out1 stride 16, pan_out0 stride 32),
NCHW, of `out_channels` x width channels. `PAFPNNeck` is the neck over
any network; `YOLOPAFPN` puts it over CSPDarknet, and
`models.pafpn_variants` over the other backbones an exp's
`backbone_name` names."""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, BNStats, CSPLayer, conv_cls
from .darknet import CSPDarknet

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PAFPNNeck(nn.Module):
    """A backbone network (`backbone`, whose dark3/dark4/dark5 maps have
    `backbone.channels` channels) and the neck over its maps, the neck's
    convs on this module itself (the reference's names:
    `backbone.lateral_conv0`). The neck's first convs read the network's
    raw channels; `n` is its CSP depth. `out_channels` is the pre-width
    pyramid the head sees."""

    def __init__(self, backbone: nn.Module, n: int, width: float = 1.0,
                 out_channels: Sequence[int] = (256, 512, 1024), depthwise: bool = False,
                 act: str = "silu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.out_channels = tuple(out_channels)
        self.dtype = dtype
        i2, i1, i0 = backbone.channels
        c0, c1, c2 = (int(c * width) for c in out_channels)
        Conv = conv_cls(depthwise)
        kw = dict(act=act, dtype=dtype)
        self.lateral_conv0 = BaseConv(i0, c1, 1, 1, **kw)
        self.C3_p4 = CSPLayer(c1 + i1, c1, n, False, depthwise=depthwise, **kw)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, **kw)
        self.C3_p3 = CSPLayer(c0 + i2, c0, n, False, depthwise=depthwise, **kw)
        self.bu_conv2 = Conv(c0, c0, 3, 2, **kw)
        self.C3_n3 = CSPLayer(2 * c0, c1, n, False, depthwise=depthwise, **kw)
        self.bu_conv1 = Conv(c1, c1, 3, 2, **kw)
        self.C3_n4 = CSPLayer(2 * c1, c2, n, False, depthwise=depthwise, **kw)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> Maps:
        """x: (F, H, W, 3) raw image, NHWC; `stats` the BN mode
        (`blocks.batch_norm`)."""
        feats = self.backbone(x, stats)
        x2, x1, x0 = feats["dark3"], feats["dark4"], feats["dark5"]
        fpn_out0 = self.lateral_conv0(x0, stats)
        f_out0 = self.C3_p4(torch.cat([upsample2x(fpn_out0), x1], 1), stats)
        fpn_out1 = self.reduce_conv1(f_out0, stats)
        pan_out2 = self.C3_p3(torch.cat([upsample2x(fpn_out1), x2], 1), stats)
        p_out1 = self.bu_conv2(pan_out2, stats)
        pan_out1 = self.C3_n3(torch.cat([p_out1, fpn_out1], 1), stats)
        p_out0 = self.bu_conv1(pan_out1, stats)
        pan_out0 = self.C3_n4(torch.cat([p_out0, fpn_out0], 1), stats)
        return pan_out2, pan_out1, pan_out0


class YOLOPAFPN(PAFPNNeck):
    """CSPDarknet and the neck, whose CSP depth is round(3 depth), JAX's
    (tscd_tpu/models/pafpn.py)."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__(CSPDarknet(depth, width, depthwise=depthwise, act=act, dtype=dtype),
                         round(3 * depth), width, in_channels, depthwise, act, dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> Maps:
        """At fp32, uint8 is cast to fp32 exactly; at bf16 the stem reads
        uint8 frames itself."""
        if x.dtype == torch.uint8 and self.dtype == torch.float32:
            x = x.to(torch.float32)
        return super().forward(x, stats)
