"""CSPDarknet backbone (counterpart of tscd_tpu/models/darknet.py;
reference darknet.py:98). base_channels = 64*width, base_depth =
max(round(3*depth), 1)."""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .blocks import BNStats, CSPLayer, Focus, SPPBottleneck, conv_cls, run


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float, wid_mul: float,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_features = tuple(out_features)
        Conv = conv_cls(depthwise)
        b = int(wid_mul * 64)
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
