"""Conv primitives of the detection core (counterpart of
tscd_tpu/models/blocks.py; reference network_blocks.py). NCHW, fp32,
eval-mode BatchNorm with eps 1e-5. The int8 machinery of the JAX package
is not ported."""

from typing import Sequence

import torch
from torch import nn

from ..ops.kernels.focus_stem import focus_stem


def get_activation(name: str = "silu") -> nn.Module:
    if name in ("silu", "swish"):
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    if name in ("id", "identity", None):
        return nn.Identity()
    raise ValueError(f"Unsupported act type: {name}")


class BaseConv(nn.Module):
    """Conv2d -> BatchNorm -> activation, 'same' padding for odd kernels."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              padding=(ksize - 1) // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """Depthwise conv followed by pointwise conv (network_blocks.py:64)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


def conv_cls(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """Standard bottleneck (network_blocks.py:158)."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = conv_cls(depthwise)(hidden, out_channels, 3, 1, act=act)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (network_blocks.py:201)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu"):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.m = nn.ModuleList(
            nn.MaxPool2d(ks, stride=1, padding=ks // 2) for ks in kernel_sizes)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels,
                              1, 1, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], 1))


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convolutions (network_blocks.py:226)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], 1))


class Focus(nn.Module):
    """Space-to-depth stem (network_blocks.py:267), eval only.

    Takes the raw (F, H, W, 3) image. BN folds into scale/shift as in
    blocks.py:580-598 and the stem (6x6/s2 conv + shift + SiLU) runs as
    the hand kernel `ops.kernels.focus_stem`; its plain version does s2d
    + the 3x3 conv. The parameters are the reference's
    (`stem.conv.conv.weight` (O, 12, 3, 3), `stem.conv.bn.*`)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "silu"):
        super().__init__()
        if (ksize, stride, act) != (3, 1, "silu"):
            raise NotImplementedError(
                "the Focus stem kernel takes ksize 3, stride 1 and SiLU")
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride,
                             act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.conv.bn
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * scale
        return focus_stem(x, self.conv.conv.weight, scale, shift)
