"""P6 (stride-64) backbone and PAFPN (counterpart of
tscd_tpu/models/pafpn_p6.py; reference darknet.py CSPDarknetP6:182 and
yolo_pafpn_p6.py): a dark6 stage and a 4-level neck emitting stride
8/16/32/64 maps, NCHW. The stem is the port's `Focus`, so it runs the
stem kernel on the card as CSPDarknet's does. Names are JAX's
(`backbone.dark6_spp`, `lat6`, `n6`)."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .blocks import BaseConv, BNStats, CSPLayer, Focus, SPPBottleneck, conv_cls
from .pafpn import upsample2x

_SPECS = (("dark2", 128, 3), ("dark3", 256, 9), ("dark4", 512, 9), ("dark5", 768, 3),
          ("dark6", 1024, 3))


class CSPDarknetP6(nn.Module):
    def __init__(self, depth: float = 1.0, width: float = 1.0, act: str = "silu",
                 depthwise: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        w = lambda c: int(c * width)            # noqa: E731
        d = lambda n: max(round(n * depth), 1)  # noqa: E731
        Conv = conv_cls(depthwise)
        kw = dict(act=act, dtype=dtype)
        self.stem = Focus(3, w(64), 3, **kw)
        cin = w(64)
        for name, ch, n in _SPECS:
            last = name == "dark6"
            setattr(self, f"{name}_conv", Conv(cin, w(ch), 3, 2, **kw))
            if last:
                setattr(self, f"{name}_spp", SPPBottleneck(w(ch), w(ch), **kw))
            setattr(self, f"{name}_csp", CSPLayer(w(ch), w(ch), d(n), not last,
                                                  depthwise=depthwise, **kw))
            cin = w(ch)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Dict[str, torch.Tensor]:
        """x (F, H, W, 3) raw image, as the Focus stem takes it."""
        x = self.stem(x, stats)
        outs = {}
        for name, _, _ in _SPECS:
            x = getattr(self, f"{name}_conv")(x, stats)
            if name == "dark6":
                x = self.dark6_spp(x, stats)
            x = getattr(self, f"{name}_csp")(x, stats)
            outs[name] = x
        return outs


class YOLOPAFPNP6(nn.Module):
    """4-level PAFPN over CSPDarknetP6 (yolo_pafpn_p6.py): returns (p3, n4,
    n5, n6) of (256, 512, 768, 1024) x width channels."""

    out_channels = (256, 512, 768, 1024)

    def __init__(self, depth: float = 1.0, width: float = 1.0, act: str = "silu",
                 depthwise: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        w = lambda c: int(c * width)            # noqa: E731
        n = max(round(3 * depth), 1)
        Conv = conv_cls(depthwise)
        kw = dict(act=act, dtype=dtype)
        csp = lambda cin, ch: CSPLayer(cin, w(ch), n, False, depthwise=depthwise, **kw)  # noqa: E731
        self.backbone = CSPDarknetP6(depth, width, act, depthwise, dtype)
        self.lat6 = BaseConv(w(1024), w(768), 1, 1, **kw)
        self.p5 = csp(2 * w(768), 768)
        self.lat5 = BaseConv(w(768), w(512), 1, 1, **kw)
        self.p4 = csp(2 * w(512), 512)
        self.lat4 = BaseConv(w(512), w(256), 1, 1, **kw)
        self.p3 = csp(2 * w(256), 256)
        self.down3 = Conv(w(256), w(256), 3, 2, **kw)
        self.n4 = csp(2 * w(256), 512)
        self.down4 = Conv(w(512), w(512), 3, 2, **kw)
        self.n5 = csp(2 * w(512), 768)
        self.down5 = Conv(w(768), w(768), 3, 2, **kw)
        self.n6 = csp(2 * w(768), 1024)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, ...]:
        """x (F, H, W, 3), H and W multiples of 64; at fp32 uint8 frames are
        cast to fp32 exactly, at bf16 the stem reads them (as YOLOPAFPN)."""
        if x.dtype == torch.uint8 and self.dtype == torch.float32:
            x = x.to(torch.float32)
        f = self.backbone(x, stats)
        cat = lambda *t: torch.cat(t, 1)        # noqa: E731
        lat6 = self.lat6(f["dark6"], stats)
        p5 = self.p5(cat(upsample2x(lat6), f["dark5"]), stats)
        lat5 = self.lat5(p5, stats)
        p4 = self.p4(cat(upsample2x(lat5), f["dark4"]), stats)
        lat4 = self.lat4(p4, stats)
        p3 = self.p3(cat(upsample2x(lat4), f["dark3"]), stats)
        n4 = self.n4(cat(self.down3(p3, stats), lat4), stats)
        n5 = self.n5(cat(self.down4(n4, stats), lat5), stats)
        n6 = self.n6(cat(self.down5(n5, stats), lat6), stats)
        return p3, n4, n5, n6
