"""The YOLOv8 family (counterpart of tscd_tpu/models/yolov8.py; reference
yolov8_blocks.py C2f:73, yolov8_pafpn.py YOLOv8PAFPN:95, yolov8_head.py
YOLOv8Head:18 with DFL). NCHW; an anchor-free decoupled head whose box
regression is Distribution Focal Loss bins, decoded to (B, A, 4 + C).

There is no reference torch module here: the names are JAX's flax names
one to one (`backbone.backbone.c2f1.m0_cv1`, `head.reg_pred_0`), which
`utils.convert` carries both ways. The loss is `train.v8_losses`.
"""

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from .blocks import BaseConv, BNStats, SPPBottleneck
from .pafpn import upsample2x
from .yolo_head import flatten_levels
from .yolox import StillDetector


class C2f(nn.Module):
    """CSP bottleneck with 2 convs and n inner bottlenecks (yolov8_blocks
    C2f:73): cv1 splits, each bottleneck (m{i}_cv1, m{i}_cv2) extends the
    chain, cv2 merges every piece."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = False, e: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = int(out_channels * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = BaseConv(in_channels, 2 * c, 1, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}_cv1", BaseConv(c, c, 3, 1, dtype=dtype))
            setattr(self, f"m{i}_cv2", BaseConv(c, c, 3, 1, dtype=dtype))
        self.cv2 = BaseConv((2 + n) * c, out_channels, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        outs = list(self.cv1(x, stats).chunk(2, 1))
        h = outs[1]
        for i in range(self.n):
            b = getattr(self, f"m{i}_cv2")(getattr(self, f"m{i}_cv1")(h, stats), stats)
            h = h + b if self.shortcut else b
            outs.append(h)
        return self.cv2(torch.cat(outs, 1), stats)


def _scalers(depth: float, width: float):
    return (lambda c: int(c * width)), (lambda n: max(round(n * depth), 1))


class YOLOv8Backbone(nn.Module):
    """Takes (B, H, W, 3) frames (fp32 or uint8) and divides them by 255
    in the compute dtype, as JAX; returns (c3, c4, c5), NCHW."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w, d = _scalers(depth, width)
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.stem = BaseConv(3, w(64), 3, 2, **kw)
        self.down1 = BaseConv(w(64), w(128), 3, 2, **kw)
        self.c2f1 = C2f(w(128), w(128), d(3), True, **kw)
        self.down2 = BaseConv(w(128), w(256), 3, 2, **kw)
        self.c2f2 = C2f(w(256), w(256), d(6), True, **kw)
        self.down3 = BaseConv(w(256), w(512), 3, 2, **kw)
        self.c2f3 = C2f(w(512), w(512), d(6), True, **kw)
        self.down4 = BaseConv(w(512), w(1024), 3, 2, **kw)
        self.c2f4 = C2f(w(1024), w(1024), d(3), True, **kw)
        self.sppf = SPPBottleneck(w(1024), w(1024), **kw)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        x = self.c2f1(self.down1(self.stem(x, stats), stats), stats)
        c3 = self.c2f2(self.down2(x, stats), stats)
        c4 = self.c2f3(self.down3(c3, stats), stats)
        c5 = self.sppf(self.c2f4(self.down4(c4, stats), stats), stats)
        return c3, c4, c5


class YOLOv8PAFPN(nn.Module):
    """(yolov8_pafpn.py:95) the backbone and its top-down / bottom-up C2f
    neck; returns (p3, n4, n5) of (256, 512, 1024) x width channels."""

    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w, d = _scalers(depth, width)
        kw = dict(dtype=dtype)
        self.backbone = YOLOv8Backbone(depth, width, dtype)
        self.p4 = C2f(w(1024) + w(512), w(512), d(3), **kw)
        self.p3 = C2f(w(512) + w(256), w(256), d(3), **kw)
        self.down_p3 = BaseConv(w(256), w(256), 3, 2, **kw)
        self.n4 = C2f(w(256) + w(512), w(512), d(3), **kw)
        self.down_n4 = BaseConv(w(512), w(512), 3, 2, **kw)
        self.n5 = C2f(w(512) + w(1024), w(1024), d(3), **kw)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None):
        c3, c4, c5 = self.backbone(x, stats)
        cat = lambda *t: torch.cat(t, 1)       # noqa: E731
        p4 = self.p4(cat(upsample2x(c5), c4), stats)
        p3 = self.p3(cat(upsample2x(p4), c3), stats)
        n4 = self.n4(cat(self.down_p3(p3, stats), p4), stats)
        n5 = self.n5(cat(self.down_n4(n4, stats), c5), stats)
        return p3, n4, n5


class YOLOv8Head(nn.Module):
    """Anchor-free decoupled head with DFL box bins (yolov8_head.py:18):
    per level `reg_{k}_0/1` + `reg_pred_{k}` (4 reg_max bins) and
    `cls_{k}_0/1` + `cls_pred_{k}` (bias at -log 99)."""

    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.strides, self.reg_max = num_classes, tuple(strides), reg_max
        c2 = max(16, int(64 * width), 4 * reg_max)
        c3 = max(int(64 * width), num_classes)
        kw = dict(dtype=dtype)
        for k, cin in enumerate(in_channels):
            setattr(self, f"reg_{k}_0", BaseConv(cin, c2, 3, 1, **kw))
            setattr(self, f"reg_{k}_1", BaseConv(c2, c2, 3, 1, **kw))
            setattr(self, f"reg_pred_{k}", nn.Conv2d(c2, 4 * reg_max, 1, **kw))
            setattr(self, f"cls_{k}_0", BaseConv(cin, c3, 3, 1, **kw))
            setattr(self, f"cls_{k}_1", BaseConv(c3, c3, 3, 1, **kw))
            pred = nn.Conv2d(c3, num_classes, 1, **kw)
            with torch.no_grad():
                pred.bias.fill_(-math.log(99.0))
            setattr(self, f"cls_pred_{k}", pred)

    def forward(self, xin: Sequence[torch.Tensor], stats: Optional[BNStats] = None
                ) -> Dict[str, Any]:
        """-> {"outputs": (B, A, 4 reg_max + C) raw, "hw": [(H, W)] a level}."""
        levels, hw = [], []
        for k, x in enumerate(xin):
            hw.append((x.shape[2], x.shape[3]))
            part = lambda name, z: getattr(self, f"{name}_{k}_1")(  # noqa: E731
                getattr(self, f"{name}_{k}_0")(z, stats), stats)
            levels.append(torch.cat([getattr(self, f"reg_pred_{k}")(part("reg", x)),
                                     getattr(self, f"cls_pred_{k}")(part("cls", x))], 1))
        return {"outputs": flatten_levels(levels), "hw": hw}

    def decode(self, out: torch.Tensor, hw) -> torch.Tensor:
        """The DFL expectation (softmax over the bins) -> ltrb distances in
        strides -> cxcywh pixels, and the sigmoid class scores, in fp32:
        (B, A, 4 + C)."""
        R = self.reg_max
        reg = out[..., :4 * R].float()
        cls = torch.sigmoid(out[..., 4 * R:].float())
        B, A, _ = reg.shape
        bins = torch.arange(R, dtype=torch.float32, device=out.device)
        ltrb = torch.softmax(reg.reshape(B, A, 4, R), -1) @ bins
        xy, s = anchor_points(hw, self.strides, out.device)
        lt, rb = ltrb[..., :2] * s[:, None], ltrb[..., 2:] * s[:, None]
        x1y1, x2y2 = xy - lt, xy + rb
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1, cls], -1)


def anchor_points(hw, strides: Sequence[int], device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchor centres (A, 2) in pixels, (x + 0.5, y + 0.5) x stride in
    raster order a level, and each anchor's stride (A,), fp32."""
    xys, ss = [], []
    for (h, w), s in zip(hw, strides):
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        xys.append(torch.stack([(xx.reshape(-1) + 0.5) * s, (yy.reshape(-1) + 0.5) * s], -1))
        ss.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(xys), torch.cat(ss)


class YOLOv8(StillDetector):
    """YOLOv8PAFPN + YOLOv8Head, built on `device` (the card unless the
    caller passes another); `dtype` is JAX's compute dtype (fp32 or
    bf16)."""

    def __init__(self, num_classes: int = 80, depth: float = 1.0, width: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = YOLOv8PAFPN(depth, width, dtype)
        self.head = YOLOv8Head(num_classes, width, in_channels=self.backbone.out_channels,
                               dtype=dtype)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False, decode: bool = True
                ) -> Dict[str, Any]:
        """x: (B, H, W, 3) frames, H and W multiples of 32. Returns the
        head's dict and, with `decode`, "decoded" (B, A, 4 + C); with
        `train`, BN on the batch's statistics and out["batch_stats"]."""
        out = self._run(x, train, lambda x, stats: self.head(self.backbone(x, stats), stats))
        if decode:
            out["decoded"] = self.head.decode(out["outputs"], out["hw"])
        return out
