"""PAFPN necks over the other backbones (counterpart of
tscd_tpu/models/pafpn_variants.py; reference yolo_pafpn.py:
YOLOPAFPN_Swin:120, YOLOPAFPN_ResNet:241, YOLOPAFPN_focal:350), the
legacy YOLOFPN over Darknet-53 (yolo_fpn.py:12), and the exp's
`backbone_name` -> feature pyramid (`build_pafpn_backbone`).

Each wrapper is `pafpn.PAFPNNeck` (the YOLOPAFPN neck, its convs on the
wrapper itself: the reference's names, `backbone.lateral_conv0`) over a
backbone network (`backbone`), and emits stride 8/16/32 maps of
`out_channels` x width channels (NCHW), so every head is
backbone-agnostic. The neck's CSP depth is max(round(3 depth), 1), JAX's
(pafpn_variants.py:41).
"""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .blocks import BaseConv, BNStats
from .darknet import Darknet
from .focalnet import build_focalnet
from .pafpn import Maps, PAFPNNeck, YOLOPAFPN, upsample2x
from .resnet import ResNet
from .swin import swin_base, swin_small, swin_tiny


class _BackbonePAFPN(PAFPNNeck):
    """`backbone` (with its dark3/dark4/dark5 maps' `channels`) and the
    neck at JAX's depth rule."""

    def __init__(self, backbone: nn.Module, depth: float = 1.0, width: float = 1.0,
                 act: str = "silu", depthwise: bool = False,
                 out_channels: Sequence[int] = (256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__(backbone, max(round(3 * depth), 1), width, out_channels, depthwise,
                         act, dtype)


class YOLOPAFPN_Swin(_BackbonePAFPN):
    """(yolo_pafpn.py:120) Swin tiny/small/base by `variant`."""

    def __init__(self, variant: str = "tiny", **kw):
        factory = {"tiny": swin_tiny, "small": swin_small, "base": swin_base}[variant]
        super().__init__(factory(dtype=kw.get("dtype", torch.float32)), **kw)


class YOLOPAFPN_Focal(_BackbonePAFPN):
    """(yolo_pafpn.py:350) FocalNet by `variant` (focalnet.build_focalnet)."""

    def __init__(self, variant: str = "focalnet_tiny", **kw):
        super().__init__(build_focalnet(variant, dtype=kw.get("dtype", torch.float32)), **kw)


class YOLOPAFPN_ResNet(_BackbonePAFPN):
    """(yolo_pafpn.py:241) ResNet-50/101 by `res_depth`."""

    def __init__(self, res_depth: int = 50, **kw):
        super().__init__(ResNet(res_depth, dtype=kw.get("dtype", torch.float32)), **kw)


class YOLOFPN(nn.Module):
    """JAX's YOLOv3 FPN over Darknet (pafpn_variants.py:124-154): five
    lrelu embedding convs on dark5, a lateral 1x1, upsample and concat
    with dark4, five more, and again with dark3; no PAN. Returns
    (out2 128, out1 256, out0 512 channels), NCHW."""

    out_channels = (128, 256, 512)

    def __init__(self, depth: int = 53, act: str = "lrelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = Darknet(depth, dtype=dtype)
        kw = dict(act=act, dtype=dtype)
        self._embedding("embed0", 1024, 512, kw)
        self.lateral0 = BaseConv(512, 256, 1, 1, **kw)
        self._embedding("embed1", 256 + 512, 256, kw)
        self.lateral1 = BaseConv(256, 128, 1, 1, **kw)
        self._embedding("embed2", 128 + 256, 128, kw)

    def _embedding(self, name: str, cin: int, ch: int, kw: Dict):
        for i, (c, k) in enumerate(((ch, 1), (2 * ch, 3), (ch, 1), (2 * ch, 3), (ch, 1))):
            setattr(self, f"{name}_{i}", BaseConv(cin, c, k, 1, **kw))
            cin = c

    def _embed(self, name: str, z: torch.Tensor, stats: Optional[BNStats]) -> torch.Tensor:
        for i in range(5):
            z = getattr(self, f"{name}_{i}")(z, stats)
        return z

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> Maps:
        feats = self.backbone(x, stats)
        x2, x1, x0 = feats["dark3"], feats["dark4"], feats["dark5"]
        out0 = self._embed("embed0", x0, stats)
        x1_in = torch.cat([upsample2x(self.lateral0(out0, stats)), x1], 1)
        out1 = self._embed("embed1", x1_in, stats)
        x2_in = torch.cat([upsample2x(self.lateral1(out1, stats)), x2], 1)
        return self._embed("embed2", x2_in, stats), out1, out0


def build_pafpn_backbone(name: Optional[str], depth: float, width: float,
                         act: str = "silu", depthwise: bool = False,
                         dtype: torch.dtype = torch.float32) -> nn.Module:
    """Exp `backbone_name` -> feature pyramid (pafpn_variants.py:157-201):

      "MCSP"         CSPDarknet YOLOPAFPN (the default)
      "Swin_Tiny"    Swin-T -> neck out (192, 384, 768) x width
      "Swin_Base"    Swin-B -> (256, 512, 1024) x width
      "...Focal..."  FocalNet focalnet_tscd -> (256, 512, 1024) x width

    Every one returns (p3, p4, p5) stride 8/16/32 maps, with the pre-width
    channels in `.out_channels`; any other name raises ValueError. The
    models' `remat_backbone` checkpoints the whole pyramid."""
    kw = dict(depth=depth, width=width, act=act, depthwise=depthwise, dtype=dtype)
    if name in ("MCSP", "mcsp", None, ""):
        return YOLOPAFPN(**kw)
    if name == "Swin_Tiny":
        return YOLOPAFPN_Swin("tiny", out_channels=(192, 384, 768), **kw)
    if name == "Swin_Base":
        return YOLOPAFPN_Swin("base", out_channels=(256, 512, 1024), **kw)
    if "Focal" in name:
        return YOLOPAFPN_Focal("focalnet_tscd", out_channels=(256, 512, 1024), **kw)
    raise ValueError(f"unknown backbone_name {name!r} (MCSP | Swin_Tiny | Swin_Base | Focal)")
