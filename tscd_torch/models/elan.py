"""The YOLOv7 ELAN family (counterpart of tscd_tpu/models/elan.py;
reference ELANNet.py: BaseConv:41, ELANLayer:422, ELAN2Layer:480,
MPConvLayer:505, DownC:542, SPPCSPC:557, SPPELAN:640, RepConv:625,
ELANNet:745, ELANFPN:985, ELANFPNP6:1145; yolov7.py YOLOv7:11). NCHW.

Names are the reference's torch names, as JAX's reader of its checkpoints
maps them (tscd_tpu/utils/convert.py:293-373): the stem `stem.{i}` (L, X,
tiny) or the Focus `stem.conv` (W6, E6, D6, E6E), each stage
`blocks.{i}.{j}` (its downsample, a paramless max-pool for tiny's later
stages, the ELAN block, the last stage's SPP), `bottlenecks.{i}`,
`rbr_dense.0/1`, `rbr_1x1.0/1`, `rbr_identity`, `repconvs.{i}`;
`utils.convert` carries them to JAX's flax tree and back.

As JAX's modules: EConv's BatchNorm has eps 1e-3 and flax momentum 0.97
(torch momentum 0.03, `blocks.batch_norm`), RepConv's eps 1e-5 and 0.9.
At a bf16 compute dtype the convs run in bf16 and each BatchNorm, its
SiLU and what follows up to the next conv (concats, pools, sums,
upsamples) in fp32, as JAX's EConv keeps the fp32 BatchNorm output; the
P6 archs' Focus stem writes the compute dtype, as JAX's does.
"""

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.decode import decode_outputs
from .blocks import BNStats, Focus, batch_norm
from .pafpn import upsample2x
from .yolo_head import YOLOXHead
from .yolox import StillDetector


def _conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
             stats: Optional[BNStats]) -> torch.Tensor:
    """conv in its weights' dtype, then BatchNorm in fp32, left fp32."""
    return batch_norm(bn, conv(x.to(conv.weight.dtype)).float(), stats)


class EConv(nn.Module):
    """ELANNet.py:41 BaseConv: conv ((k - 1) // 2 padding, no bias) + BN
    (eps 1e-3, flax momentum 0.97) + SiLU, the output fp32."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int, stride: int = 1,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        return F.silu(_conv_bn(self.conv, self.bn, x, stats))


class ELANLayer(nn.Module):
    """(ELANNet.py:422) two 1x1 entries and `num_blocks` chained 3x3
    convs; the entries `concat_list` picks (negative, from the end) are
    concatenated in reverse, then a 1x1."""

    def __init__(self, in_channels: int, mid1: int, mid2: int, out_channels: int,
                 num_blocks: int = 4, concat_list: Sequence[int] = (-1, -3, -5, -6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = EConv(in_channels, mid1, 1, dtype=dtype)
        self.conv2 = EConv(in_channels, mid1, 1, dtype=dtype)
        self.bottlenecks = nn.ModuleList(EConv(mid1 if i == 0 else mid2, mid2, 3, dtype=dtype)
                                         for i in range(num_blocks))
        self.picked = {i + num_blocks for i in concat_list[:-2]} & set(range(num_blocks))
        self.conv3 = EConv(2 * mid1 + len(self.picked) * mid2, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        outs = [self.conv1(x, stats), self.conv2(x, stats)]
        h = outs[1]
        for i, m in enumerate(self.bottlenecks):
            h = m(h, stats)
            if i in self.picked:
                outs.append(h)
        return self.conv3(torch.cat(outs[::-1], 1), stats)


class ELAN2Layer(nn.Module):
    """(ELANNet.py:480) two parallel ELANLayers, summed (E6E)."""

    def __init__(self, *args, **kw):
        super().__init__()
        self.elan_layer1 = ELANLayer(*args, **kw)
        self.elan_layer2 = ELANLayer(*args, **kw)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        return self.elan_layer1(x, stats) + self.elan_layer2(x, stats)


class MPConvLayer(nn.Module):
    """(ELANNet.py:505) max-pool + 1x1 beside 1x1 + 3x3/2, the conv path
    first in the concat: 2 int(out_channels expansion) channels out."""

    def __init__(self, in_channels: int, out_channels: int, expansion: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = int(out_channels * expansion)
        self.conv1 = EConv(in_channels, mid, 1, dtype=dtype)
        self.conv2 = EConv(in_channels, mid, 1, dtype=dtype)
        self.conv3 = EConv(mid, mid, 3, 2, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        x1 = self.conv1(F.max_pool2d(x, 2, 2), stats)
        return torch.cat([self.conv3(self.conv2(x, stats), stats), x1], 1)


class DownC(nn.Module):
    """(ELANNet.py:542) 1x1 + 3x3/k beside max-pool + 1x1 (E6, D6, E6E)."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.cv1 = EConv(in_channels, in_channels, 1, dtype=dtype)
        self.cv2 = EConv(in_channels, out_channels // 2, 3, k, dtype=dtype)
        self.cv3 = EConv(in_channels, out_channels // 2, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        return torch.cat([self.cv2(self.cv1(x, stats), stats),
                          self.cv3(F.max_pool2d(x, self.k, self.k), stats)], 1)


def _maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(k, 1, padding=k // 2): -inf padding, as JAX's."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPPCSPC(nn.Module):
    """(ELANNet.py:557) a CSP split around max-pools of (5, 9, 13)."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 pool_ks: Sequence[int] = (5, 9, 13), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_ks = tuple(pool_ks)
        c = int(2 * out_channels * e)
        kw = dict(dtype=dtype)
        self.cv1 = EConv(in_channels, c, 1, **kw)
        self.cv2 = EConv(in_channels, c, 1, **kw)
        self.cv3 = EConv(c, c, 3, **kw)
        self.cv4 = EConv(c, c, 1, **kw)
        self.cv5 = EConv(c * (len(pool_ks) + 1), c, 1, **kw)
        self.cv6 = EConv(c, c, 3, **kw)
        self.cv7 = EConv(2 * c, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        a = self.cv4(self.cv3(self.cv1(x, stats), stats), stats)
        a = self.cv5(torch.cat([a] + [_maxpool_same(a, k) for k in self.pool_ks], 1), stats)
        a = self.cv6(a, stats)
        return self.cv7(torch.cat([a, self.cv2(x, stats)], 1), stats)


class SPPELAN(nn.Module):
    """(ELANNet.py:640) tiny's SPP: two 1x1 and the pools, reversed."""

    def __init__(self, in_channels: int, out_channels: int, e: float = 0.5,
                 pool_ks: Sequence[int] = (5, 9, 13), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_ks = tuple(pool_ks)
        c = int(2 * out_channels * e)
        self.cv1 = EConv(in_channels, c, 1, dtype=dtype)
        self.cv2 = EConv(in_channels, c, 1, dtype=dtype)
        self.cv3 = EConv(c * (len(pool_ks) + 1), c, 1, dtype=dtype)
        self.cv4 = EConv(2 * c, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        x1, x2 = self.cv1(x, stats), self.cv2(x, stats)
        cats = [x2] + [_maxpool_same(x2, k) for k in self.pool_ks]
        return self.cv4(torch.cat([self.cv3(torch.cat(cats[::-1], 1), stats), x1], 1), stats)


def _branch(in_channels: int, out_channels: int, k: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, k, stride, k // 2, bias=False,
                                   dtype=dtype),
                         nn.BatchNorm2d(out_channels, eps=1e-5))


class RepConv(nn.Module):
    """(ELANNet.py:625) RepVGG block: 3x3 + 1x1 (+ an identity BN at
    stride 1 with equal channels), summed, then SiLU. Its BNs have torch's
    eps 1e-5 and flax momentum 0.9."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rbr_dense = _branch(in_channels, out_channels, 3, stride, dtype)
        self.rbr_1x1 = _branch(in_channels, out_channels, 1, stride, dtype)
        self.rbr_identity = (nn.BatchNorm2d(in_channels, eps=1e-5)
                             if stride == 1 and in_channels == out_channels else None)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None) -> torch.Tensor:
        out = (_conv_bn(*self.rbr_dense, x, stats) + _conv_bn(*self.rbr_1x1, x, stats))
        if self.rbr_identity is not None:
            out = out + batch_norm(self.rbr_identity, x.float(), stats)
        return F.silu(out)


class ImplicitA(nn.Module):
    """(ELANNet.py:605) a learned additive prior (YOLOR); `ia` in JAX's
    (1, 1, 1, C) layout, normal(0.02) as JAX initialises it."""

    def __init__(self, channels: int):
        super().__init__()
        self.ia = nn.Parameter(0.02 * torch.randn(1, 1, 1, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ia.permute(0, 3, 1, 2)


class ImplicitM(nn.Module):
    """(ELANNet.py:616) a learned multiplicative prior (YOLOR); `im` as
    ImplicitA's `ia`."""

    def __init__(self, channels: int):
        super().__init__()
        self.im = nn.Parameter(0.02 * torch.randn(1, 1, 1, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.im.permute(0, 3, 1, 2)


# -- the backbone ---------------------------------------------------------
# [in_ch, out_ch] of the stem and each stage (ELANNet.py:762); JAX's tables
ARCHS = ("tiny", "L", "X", "W6", "E6", "D6", "E6E")
P6_ARCHS = ("W6", "E6", "D6", "E6E")
_CH = {
    "tiny": [[32, 64], [64, 64], [64, 128], [128, 256], [256, 512]],
    "L": [[32, 64], [64, 256], [256, 512], [512, 1024], [1024, 1024]],
    "X": [[40, 80], [80, 320], [320, 640], [640, 1280], [1280, 1280]],
    "W6": [[64, 64], [64, 128], [128, 256], [256, 512], [512, 768], [768, 1024]],
    "E6": [[80, 80], [80, 160], [160, 320], [320, 640], [640, 960], [960, 1280]],
    "D6": [[96, 96], [96, 192], [192, 384], [384, 768], [768, 1152], [1152, 1536]],
    "E6E": [[80, 80], [80, 160], [160, 320], [320, 640], [640, 960], [960, 1280]],
}
_MID = {
    "tiny": [[32, 32], [64, 64], [128, 128], [256, 256]],
    "L": [[64, 64], [128, 128], [256, 256], [256, 256]],
    "X": [[64, 64], [128, 128], [256, 256], [256, 256]],
    "W6": [[64, 64], [128, 128], [256, 256], [384, 384], [512, 512]],
    "E6": [[64, 64], [128, 128], [256, 256], [384, 384], [512, 512]],
    "D6": [[64, 64], [128, 128], [256, 256], [384, 384], [512, 512]],
    "E6E": [[64, 64], [128, 128], [256, 256], [384, 384], [512, 512]],
}
_CONCAT = {
    "tiny": (-1, -2, -3, -4),
    "L": (-1, -3, -5, -6),
    "X": (-1, -3, -5, -7, -8),
    "W6": (-1, -3, -5, -6),
    "E6": (-1, -3, -5, -7, -8),
    "D6": (-1, -3, -5, -7, -9, -10),
    "E6E": (-1, -3, -5, -7, -8),
}
_NBLOCKS = {"tiny": 2, "L": 4, "X": 6, "W6": 4, "E6": 6, "D6": 8, "E6E": 6}


def backbone_channels(arch: str) -> Tuple[int, ...]:
    """Channels of each stage's output (the last one's SPP halves it)."""
    chs = [c[1] for c in _CH[arch][1:]]
    return tuple(chs[:-1]) + (chs[-1] // 2,)


class ELANNet(nn.Module):
    """(ELANNet.py:745) the YOLOv7 backbone. Takes the raw (F, H, W, 3)
    image (fp32, or uint8: cast to fp32 exactly at fp32, read by the Focus
    stem as it is at bf16) and returns the maps of the stages
    `return_idx` names (2, 3, 4 -> strides 8, 16, 32; the P6 archs' 5 ->
    64), NCHW. The last stage ends with SPPCSPC (SPPELAN for tiny)."""

    def __init__(self, arch: str = "L", return_idx: Sequence[int] = (2, 3, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if arch not in _CH:
            raise ValueError(f"unknown ELAN arch {arch!r}: one of {ARCHS}")
        self.arch, self.return_idx, self.dtype = arch, tuple(return_idx), dtype
        chs, mids, nb = _CH[arch], _MID[arch], _NBLOCKS[arch]
        kw = dict(dtype=dtype)
        ch_1, cin = chs[0]
        if arch in ("L", "X"):
            self.stem = nn.Sequential(EConv(3, ch_1, 3, 1, **kw), EConv(ch_1, 2 * ch_1, 3, 2, **kw),
                                      EConv(2 * ch_1, cin, 3, 1, **kw))
        elif arch == "tiny":
            self.stem = nn.Sequential(EConv(3, ch_1, 3, 2, **kw), EConv(ch_1, cin, 3, 2, **kw))
        else:                                   # ReOrg + conv: the Focus stem
            self.stem = Focus(3, cin, 3, act="silu", dtype=dtype)
        elan = ELAN2Layer if arch == "E6E" else ELANLayer
        self.blocks = nn.ModuleList()
        for i, (in_ch, out_ch) in enumerate(chs[1:]):
            stage = []
            if arch in ("L", "X"):
                stage.append(EConv(cin, out_ch // 2, 3, 2, **kw) if i == 0
                             else MPConvLayer(cin, in_ch, 0.5, **kw))
                cin = out_ch // 2 if i == 0 else 2 * int(in_ch * 0.5)
            elif arch == "tiny":
                if i > 0:
                    stage.append(nn.MaxPool2d(2, 2))
            elif arch == "W6":
                stage.append(EConv(cin, out_ch, 3, 2, **kw))
                cin = out_ch
            else:
                stage.append(DownC(cin, out_ch, 2, **kw))
                cin = out_ch // 2 * 2
            stage.append(elan(cin, mids[i][0], mids[i][1], out_ch, nb, _CONCAT[arch], **kw))
            cin = out_ch
            if i == len(chs) - 2:
                stage.append((SPPELAN if arch == "tiny" else SPPCSPC)(cin, out_ch // 2, **kw))
            self.blocks.append(nn.Sequential(*stage))

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, ...]:
        if isinstance(self.stem, Focus):
            if x.dtype == torch.uint8 and self.dtype == torch.float32:
                x = x.to(torch.float32)
            x = self.stem(x, stats)
        else:                                   # each conv casts to its dtype
            x = x.permute(0, 3, 1, 2)
            for m in self.stem:
                x = m(x, stats)
        outs = []
        for stage in self.blocks:
            for m in stage:
                x = m(x) if isinstance(m, nn.MaxPool2d) else m(x, stats)
            outs.append(x)
        return tuple(outs[i - 1] for i in self.return_idx)


# -- the necks ------------------------------------------------------------
# [in_ch, mid1, mid2, out_ch] of each ELANLayer (2 FPN + 2 PAN), ELANNet.py:992
_FPN_CH = {
    "tiny": [[256, 64, 64, 128], [128, 32, 32, 64], [64, 64, 64, 128], [128, 128, 128, 256]],
    "L": [[512, 256, 128, 256], [256, 128, 64, 128], [128, 256, 128, 256],
          [256, 512, 256, 512]],
    "X": [[640, 256, 256, 320], [320, 128, 128, 160], [160, 256, 256, 320],
          [320, 512, 512, 640]],
}
_FPN_CONCAT = {"tiny": (-1, -2, -3, -4), "L": (-1, -2, -3, -4, -5, -6),
               "X": (-1, -3, -5, -7, -8)}
_FPN_NBLOCKS = {"tiny": 2, "L": 4, "X": 6}


class ELANFPN(nn.Module):
    """(ELANNet.py:985) the YOLOv7 P5 neck: top-down FPN and bottom-up PAN
    of ELANLayers over (c3, c4, c5) of `in_channels`; RepConv outputs
    (EConv for tiny and X) double the channels: `out_channels`."""

    def __init__(self, arch: str = "L", in_channels: Sequence[int] = (512, 1024, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chs, nb, concat = _FPN_CH[arch], _FPN_NBLOCKS[arch], _FPN_CONCAT[arch]
        c3, c4, c5 = in_channels
        kw = dict(dtype=dtype)
        elan = lambda cin, s: ELANLayer(cin, s[1], s[2], s[3], nb, concat, **kw)  # noqa: E731
        o = [s[3] for s in chs]
        self.lateral_conv1 = EConv(c5, o[0], 1, **kw)
        self.route_conv1 = EConv(c4, o[0], 1, **kw)
        self.elan_fpn1 = elan(2 * o[0], chs[0])
        self.lateral_conv2 = EConv(o[0], o[1], 1, **kw)
        self.route_conv2 = EConv(c3, o[1], 1, **kw)
        self.elan_fpn2 = elan(2 * o[1], chs[1])
        down = ((lambda cin, c: EConv(cin, c, 3, 2, **kw)) if arch == "tiny"
                else (lambda cin, c: MPConvLayer(cin, c, 0.5, **kw)))
        self.mp_conv1 = down(o[1], o[2])
        self.elan_pan1 = elan(o[2] + o[0], chs[2])
        self.mp_conv2 = down(o[2], o[3])
        self.elan_pan2 = elan(o[3] + c5, chs[3])
        rep = (lambda cin, c: RepConv(cin, c, **kw)) if arch == "L" else (
            lambda cin, c: EConv(cin, c, 3, 1, **kw))
        self.out_channels = tuple(2 * c for c in o[1:])
        self.repconvs = nn.ModuleList(rep(c, 2 * c) for c in o[1:])

    def forward(self, feats: Sequence[torch.Tensor], stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, ...]:
        c3, c4, c5 = feats
        cat = lambda *t: torch.cat(t, 1)       # noqa: E731
        f1 = self.elan_fpn1(cat(self.route_conv1(c4, stats),
                                upsample2x(self.lateral_conv1(c5, stats))), stats)
        f2 = self.elan_fpn2(cat(self.route_conv2(c3, stats),
                                upsample2x(self.lateral_conv2(f1, stats))), stats)
        p1 = self.elan_pan1(cat(self.mp_conv1(f2, stats), f1), stats)
        p2 = self.elan_pan2(cat(self.mp_conv2(p1, stats), c5), stats)
        return tuple(m(p, stats) for m, p in zip(self.repconvs, (f2, p1, p2)))


# [in_ch, mid1, mid2, out_ch] of each ELAN block (3 FPN + 3 PAN), ELANNet.py:1152
_P6_CH = {
    "W6": [[512, 384, 192, 384], [384, 256, 128, 256], [256, 128, 64, 128],
           [128, 256, 128, 256], [256, 384, 192, 384], [384, 512, 256, 512]],
    "E6": [[640, 384, 192, 480], [480, 256, 128, 320], [320, 128, 64, 160],
           [160, 256, 128, 320], [320, 384, 192, 480], [480, 512, 256, 640]],
    "D6": [[768, 384, 192, 576], [576, 256, 128, 384], [384, 128, 64, 192],
           [192, 256, 128, 384], [384, 384, 192, 576], [576, 512, 256, 768]],
    "E6E": [[640, 384, 192, 480], [480, 256, 128, 320], [320, 128, 64, 160],
            [160, 256, 128, 320], [320, 384, 192, 480], [480, 512, 256, 640]],
}
_P6_CONCAT = {"W6": (-1, -2, -3, -4, -5, -6), "E6": (-1, -2, -3, -4, -5, -6, -7, -8),
              "D6": (-1, -2, -3, -4, -5, -6, -7, -8, -9, -10),
              "E6E": (-1, -2, -3, -4, -5, -6, -7, -8)}
_P6_NBLOCKS = {"W6": 4, "E6": 6, "D6": 8, "E6E": 6}


class ELANFPNP6(nn.Module):
    """(ELANNet.py:1145) the YOLOv7 P6 neck: 3 top-down and 3 bottom-up
    ELAN blocks (ELAN2Layer for E6E) over (c3, c4, c5, c6) of
    `in_channels`; EConv (W6) or DownC downsamples; EConv outputs double
    the channels. Returns the stride 8/16/32/64 maps."""

    def __init__(self, arch: str = "W6", in_channels: Sequence[int] = (256, 512, 768, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chs, nb, concat = _P6_CH[arch], _P6_NBLOCKS[arch], _P6_CONCAT[arch]
        c3, c4, c5, c6 = in_channels
        kw = dict(dtype=dtype)
        block = ELAN2Layer if arch == "E6E" else ELANLayer
        elan = lambda cin, s: block(cin, s[1], s[2], s[3], nb, concat, **kw)  # noqa: E731
        down = ((lambda cin, c: EConv(cin, c, 3, 2, **kw)) if arch == "W6"
                else (lambda cin, c: DownC(cin, c, 2, **kw)))
        o = [s[3] for s in chs]
        self.lateral_conv1 = EConv(c6, o[0], 1, **kw)
        self.route_conv1 = EConv(c5, o[0], 1, **kw)
        self.elan_fpn1 = elan(2 * o[0], chs[0])
        self.lateral_conv2 = EConv(o[0], o[1], 1, **kw)
        self.route_conv2 = EConv(c4, o[1], 1, **kw)
        self.elan_fpn2 = elan(2 * o[1], chs[1])
        self.lateral_conv3 = EConv(o[1], o[2], 1, **kw)
        self.route_conv3 = EConv(c3, o[2], 1, **kw)
        self.elan_fpn3 = elan(2 * o[2], chs[2])
        self.down_conv1 = down(o[2], o[3])
        self.elan_pan1 = elan(o[3] + o[1], chs[3])
        self.down_conv2 = down(o[3], o[4])
        self.elan_pan2 = elan(o[4] + o[0], chs[4])
        self.down_conv3 = down(o[4], o[5])
        self.elan_pan3 = elan(o[5] + c6, chs[5])
        self.out_channels = tuple(2 * c for c in o[2:])
        self.repconvs = nn.ModuleList(EConv(c, 2 * c, 3, 1, **kw) for c in o[2:])

    def forward(self, feats: Sequence[torch.Tensor], stats: Optional[BNStats] = None
                ) -> Tuple[torch.Tensor, ...]:
        c3, c4, c5, c6 = feats
        cat = lambda *t: torch.cat(t, 1)       # noqa: E731
        f1 = self.elan_fpn1(cat(self.route_conv1(c5, stats),
                                upsample2x(self.lateral_conv1(c6, stats))), stats)
        f2 = self.elan_fpn2(cat(self.route_conv2(c4, stats),
                                upsample2x(self.lateral_conv2(f1, stats))), stats)
        f3 = self.elan_fpn3(cat(self.route_conv3(c3, stats),
                                upsample2x(self.lateral_conv3(f2, stats))), stats)
        p1 = self.elan_pan1(cat(self.down_conv1(f3, stats), f2), stats)
        p2 = self.elan_pan2(cat(self.down_conv2(p1, stats), f1), stats)
        p3 = self.elan_pan3(cat(self.down_conv3(p2, stats), c6), stats)
        return tuple(m(p, stats) for m, p in zip(self.repconvs, (f3, p1, p2, p3)))


class YOLOv7(StillDetector):
    """(yolov7.py:11) ELANNet + ELANFPN + the YOLOX head (P5 archs: tiny,
    L, X), built on `device` (the card unless the caller passes another).
    `dtype` is JAX's compute dtype (fp32 or bf16): the convs' weights are
    stored in it, the neck's fp32 maps are cast to it for the head, and
    decode runs in fp32."""

    def __init__(self, num_classes: int = 80, arch: str = "L", act: str = "silu",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if arch not in _FPN_CH:
            raise ValueError(f"YOLOv7 takes a P5 arch (tiny, L, X), not {arch!r}")
        self.num_classes, self.arch, self.dtype = num_classes, arch, dtype
        self.backbone = ELANNet(arch, dtype=dtype)
        self.fpn = ELANFPN(arch, backbone_channels(arch)[-3:], dtype=dtype)
        self.head = YOLOXHead(num_classes, 1.0, in_channels=self.fpn.out_channels, act=act,
                              dtype=dtype)
        self.to(resolve_device(device))
        self.eval()

    def forward(self, x: torch.Tensor, train: bool = False, decode: bool = True
                ) -> Dict[str, Any]:
        """x: (B, H, W, 3) NHWC frames (fp32 or uint8), H and W multiples
        of 32. Returns the head's {"outputs": (B, A, 5 + C) raw, "hw"} and,
        with `decode`, "decoded" (boxes in pixels, sigmoid on obj and cls);
        with `train`, BN on the batch's statistics and out["batch_stats"]."""
        out = self._run(x, train, lambda x, stats: self.head(
            [f.to(self.dtype) for f in self.fpn(self.backbone(x, stats), stats)], stats))
        if decode:
            dec = decode_outputs(out["outputs"].float(), out["hw"], self.head.strides)
            out["decoded"] = torch.cat([dec[..., :4], torch.sigmoid(dec[..., 4:])], -1)
        return out
