"""Conv primitives of the detection core (counterpart of
tscd_tpu/models/blocks.py; reference network_blocks.py). NCHW, eval-mode
BatchNorm with eps 1e-5. The int8 machinery of the JAX package is not
ported.

Compute dtype (`dtype`, fp32 or bf16), as the JAX modules' `dtype`
field: the conv weights are stored in it (cast once, at construction or
on load) and the conv and the activation run in it; BatchNorm keeps fp32
parameters and runs in fp32 on the conv's output, which is then cast
back (blocks.py:231-245). `utils.model_utils.fuse_model` folds the BN
into the conv: the conv then has a bias and `bn` is None (JAX:
`use_bias`)."""

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
                 stride: int = 1, groups: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              padding=(ksize - 1) // 2, groups=groups,
                              bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y.float()).to(y.dtype)
        return self.act(y)


class DWConv(nn.Module):
    """Depthwise conv followed by pointwise conv (network_blocks.py:64)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act, dtype=dtype)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act=act,
                              dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


def conv_cls(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """Standard bottleneck (network_blocks.py:158)."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv2 = conv_cls(depthwise)(hidden, out_channels, 3, 1, act=act,
                                         dtype=dtype)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (network_blocks.py:201)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.m = nn.ModuleList(
            nn.MaxPool2d(ks, stride=1, padding=ks // 2) for ks in kernel_sizes)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels,
                              1, 1, act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], 1))


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convolutions (network_blocks.py:226)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act=act,
                              dtype=dtype)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act,
                       dtype=dtype)
            for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        x2 = self.conv2(x)
        return self.conv3(torch.cat([x1, x2], 1))


class Focus(nn.Module):
    """Space-to-depth stem (network_blocks.py:267), eval only.

    Takes the raw (F, H, W, 3) image (fp32, or uint8 at bf16). BN folds
    into scale/shift as in blocks.py:580-598 and the stem (6x6/s2 conv +
    shift + SiLU) runs as the hand kernel `ops.kernels.focus_stem`; its
    plain version does s2d + the 3x3 conv. The parameters are the
    reference's (`stem.conv.conv.weight` (O, 12, 3, 3), `stem.conv.bn.*`)
    and stay fp32 at any compute dtype: at bf16 the kernel rounds the
    BN-folded weights to bf16 itself and writes bf16, as the Pallas
    kernel does (focus_stem.py:144-148). After `fuse_model` the conv's
    bias is the shift and the scale is 1."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (ksize, stride, act) != (3, 1, "silu"):
            raise NotImplementedError(
                "the Focus stem kernel takes ksize 3, stride 1 and SiLU")
        self.dtype = dtype
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride,
                             act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.conv.conv, self.conv.bn
        if bn is None:
            shift = conv.bias
            scale = torch.ones_like(shift)
        else:
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
        return focus_stem(x, conv.weight, scale, shift, out_dtype=self.dtype)
