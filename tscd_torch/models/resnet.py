"""ResNet-50/101 backbone (counterpart of tscd_tpu/models/resnet.py;
reference resnet.py:11 on ResNetBottleneck, network_blocks.py:292).

As the reference, and unlike torchvision: the stem is a BaseConv (conv,
BN, activation, k7 s2, padding 3), the 3x3 max pool pads 1 on each side
with -inf, and each bottleneck's ConvBn3 applies its activation before
the residual add, with another after it. Takes the raw (F, H, W, 3)
image (fp32, or uint8 cast exactly to the compute dtype; no
normalisation) and returns {"dark3", "dark4", "dark5"}: stages 3-5
(stride 8/16/32, 512/1024/2048 channels), NCHW. Names are the
reference's (`stem`, `layer{n}.{b}.ConvBn{1,2,3}`, `downsample.0`/`.1`).
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, BNStats, ResNetBottleneck, run

_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, act: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depth not in _LAYERS:
            raise ValueError(f"ResNet depth {depth}: 50 or 101")
        self.dtype = dtype
        self.stem = BaseConv(3, 64, 7, 2, act=act, dtype=dtype)
        cin = 64
        for i, (n, planes) in enumerate(zip(_LAYERS[depth], (64, 128, 256, 512))):
            blocks = [ResNetBottleneck(cin, planes, 1 if i == 0 else 2, True, act=act,
                                       dtype=dtype)]
            cin = planes * 4
            blocks += [ResNetBottleneck(cin, planes, act=act, dtype=dtype) for _ in range(1, n)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.channels = (512, 1024, 2048)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> Dict[str, torch.Tensor]:
        """x (F, H, W, 3) raw image; `stats` the BN mode (`blocks.batch_norm`)."""
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2).contiguous(), stats)
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = {}
        for i, name in enumerate(("dark2", "dark3", "dark4", "dark5")):
            x = run(getattr(self, f"layer{i + 1}"), x, stats)
            outs[name] = x
        del outs["dark2"]
        return outs
