"""CSPDarknet and the legacy Darknet-21/53 backbones (counterpart of
tscd_tpu/models/darknet.py; reference darknet.py:98 and :10).
CSPDarknet: base_channels = 64*width, base_depth = max(round(3*depth),
1). Darknet: lrelu BaseConvs and ResLayers, with JAX's names and its
dark5 SPP block (darknet.py:61-107)."""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .blocks import BaseConv, BNStats, CSPLayer, Focus, ResLayer, SPPBottleneck, conv_cls, run


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float, wid_mul: float,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        Conv = conv_cls(depthwise)
        b = int(wid_mul * 64)
        self.channels = (b * 4, b * 8, b * 16)
        d = max(round(dep_mul * 3), 1)
        kw = dict(act=act, dtype=dtype)
        self.stem = Focus(3, b, ksize=3, **kw)
        self.dark2 = nn.Sequential(
            Conv(b, b * 2, 3, 2, **kw),
            CSPLayer(b * 2, b * 2, n=d, depthwise=depthwise, **kw))
        self.dark3 = nn.Sequential(
            Conv(b * 2, b * 4, 3, 2, **kw),
            CSPLayer(b * 4, b * 4, n=d * 3, depthwise=depthwise, **kw))
        self.dark4 = nn.Sequential(
            Conv(b * 4, b * 8, 3, 2, **kw),
            CSPLayer(b * 8, b * 8, n=d * 3, depthwise=depthwise, **kw))
        self.dark5 = nn.Sequential(
            Conv(b * 8, b * 16, 3, 2, **kw),
            SPPBottleneck(b * 16, b * 16, **kw),
            CSPLayer(b * 16, b * 16, n=d, shortcut=False,
                     depthwise=depthwise, **kw))

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Dict[str, torch.Tensor]:
        """x: (F, H, W, 3) raw image, NHWC; `stats` the BN mode
        (`blocks.batch_norm`). Returns NCHW features in the compute
        dtype."""
        outputs = {}
        x = self.stem(x, stats)
        outputs["stem"] = x
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = run(getattr(self, name), x, stats)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}


class Darknet(nn.Module):
    """Darknet-21/53 (darknet.py:61): a stem conv and groups of a stride-2
    conv and ResLayers, dark5 closed by JAX's SPP block. Takes the (F, H,
    W, 3) image (fp32 or uint8, cast to the compute dtype) and returns the
    `out_features` maps, NCHW: dark3 256, dark4 512, dark5 1024 channels
    at both depths."""

    DEPTH2BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}

    def __init__(self, depth: int = 53, stem_out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        self.dtype = dtype
        kw = dict(act="lrelu", dtype=dtype)
        nb = self.DEPTH2BLOCKS[depth]
        self.stem_conv = BaseConv(3, stem_out_channels, 3, 1, **kw)
        self._group("stem_g", stem_out_channels, 1)
        cin = stem_out_channels * 2
        for name, n in zip(("dark2", "dark3", "dark4", "dark5"), nb):
            self._group(name, cin, n)
            cin *= 2
        f0, f1 = cin, cin * 2
        self.spp_c1 = BaseConv(cin, f0, 1, 1, **kw)
        self.spp_c2 = BaseConv(f0, f1, 3, 1, **kw)
        self.spp = SPPBottleneck(f1, f0, **kw)
        self.spp_c3 = BaseConv(f0, f1, 3, 1, **kw)
        self.spp_c4 = BaseConv(f1, f0, 1, 1, **kw)
        self.stages = {"stem": ("stem_g", 1), **{k: (k, n) for k, n in zip(
            ("dark2", "dark3", "dark4", "dark5"), nb)}}

    def _group(self, prefix: str, cin: int, n: int):
        setattr(self, f"{prefix}_conv", BaseConv(cin, 2 * cin, 3, 2, act="lrelu",
                                                 dtype=self.dtype))
        for i in range(n):
            setattr(self, f"{prefix}_res{i}", ResLayer(2 * cin, self.dtype))

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Dict[str, torch.Tensor]:
        x = self.stem_conv(x.to(self.dtype).permute(0, 3, 1, 2).contiguous(), stats)
        outputs = {}
        for name, (prefix, n) in self.stages.items():
            x = getattr(self, f"{prefix}_conv")(x, stats)
            for i in range(n):
                x = getattr(self, f"{prefix}_res{i}")(x, stats)
            outputs[name] = x
        for m in (self.spp_c1, self.spp_c2, self.spp, self.spp_c3, self.spp_c4):
            x = m(x, stats)
        outputs["dark5"] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
