"""Conv primitives of the detection core (counterpart of
tscd_tpu/models/blocks.py; reference network_blocks.py). NCHW,
BatchNorm with eps 1e-5. The int8 machinery of the JAX package is not
ported.

BatchNorm mode, as the JAX modules' `train` argument: each forward takes
`stats`, None for eval-mode BN (the running statistics), or a dict for
train-mode BN (`batch_norm`): the batch's statistics normalise, and the
new running statistics are put in `stats` under the BatchNorm module,
not written into its buffers, so that a step over several windows can
average them (tscd_tpu/core/tscd_trainer.py:198-214). Modules stay in
torch's eval mode either way.

Compute dtype (`dtype`, fp32 or bf16), as the JAX modules' `dtype`
field: the conv weights are stored in it (cast once, at construction or
on load) and the conv and the activation run in it; BatchNorm keeps fp32
parameters and runs in fp32 on the conv's output, which is then cast
back (blocks.py:231-245). `utils.model_utils.fuse_model` folds the BN
into the conv: the conv then has a bias and `bn` is None (JAX:
`use_bias`)."""

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.focus_stem import focus_stem, rearrange_weight

# new running statistics of a train-mode forward: {BatchNorm module:
# (running mean, running var)}
BNStats = Dict[nn.BatchNorm2d, Tuple[torch.Tensor, torch.Tensor]]


def batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor,
               stats: Optional[BNStats]) -> torch.Tensor:
    """BatchNorm of y (N, C, H, W) in fp32, cast back to y's dtype. With
    `stats` None, eval mode (the running statistics). Otherwise flax's
    train mode (nn.BatchNorm, flax 0.12.3 normalization.py): the batch
    mean and the biased variance E[x^2] - E[x]^2 (its fast variance,
    floored at 0) normalise, (x - mean) * (rsqrt(var + eps) * scale) +
    bias, and stats[bn] gets running averages of them, which carry no
    gradient: flax's momentum is 1 - `bn.momentum` (torch's default 0.1 is
    flax's 0.9; the ELAN family's 0.03 is its 0.97), running = m running +
    (1 - m) batch."""
    x = y.float()
    if stats is None:
        return bn(x).to(y.dtype)
    axes = (0, 2, 3)
    mean = x.mean(axes)
    var = ((x * x).mean(axes) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    m = 1.0 - bn.momentum
    stats[bn] = (m * bn.running_mean + (1.0 - m) * mean.detach(),
                 m * bn.running_var + (1.0 - m) * var.detach())
    return out.to(y.dtype)


def batch_stats(model: nn.Module, stats: BNStats) -> Dict[str, torch.Tensor]:
    """A train-mode forward's new running statistics under the state_dict
    keys of their BatchNorm modules."""
    return {f"{name}.running_{k}": v for name, bn in model.named_modules()
            if bn in stats for k, v in zip(("mean", "var"), stats[bn])}


def run(seq: nn.Sequential, x: torch.Tensor,
        stats: Optional[BNStats]) -> torch.Tensor:
    """The modules of `seq` in turn, each given the BN mode `stats`."""
    for m in seq:
        x = m(x, stats)
    return x


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
    """Conv2d -> BatchNorm -> activation, 'same' padding for odd kernels;
    `valid=True` runs the same parameters with no padding (the sparse
    tower path's patch convs, blocks.py:216-221)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              padding=(ksize - 1) // 2, groups=groups,
                              bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None,
                valid: bool = False) -> torch.Tensor:
        c = self.conv
        y = (F.conv2d(x, c.weight, c.bias, c.stride, 0, c.dilation, c.groups)
             if valid else c(x))
        if self.bn is not None:
            y = batch_norm(self.bn, y, stats)
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

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None,
                valid: bool = False) -> torch.Tensor:
        return self.pconv(self.dconv(x, stats, valid), stats)


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

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        y = self.conv2(self.conv1(x, stats), stats)
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

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        x = self.conv1(x, stats)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], 1), stats)


class ResLayer(nn.Module):
    """Residual 1x1 -> 3x3 lrelu layer (network_blocks.py:183)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels // 2
        self.layer1 = BaseConv(in_channels, mid, 1, 1, act="lrelu", dtype=dtype)
        self.layer2 = BaseConv(mid, in_channels, 3, 1, act="lrelu", dtype=dtype)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        return x + self.layer2(self.layer1(x, stats), stats)


class ConvBN(nn.Sequential):
    """1x1 conv then BatchNorm, no activation: the reference's ResNet
    `downsample`, an nn.Sequential (names `0` and `1`); JAX runs it as a
    BaseConv with act "id" (blocks.py:650-652)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Conv2d(in_channels, out_channels, 1, stride, bias=False,
                                   dtype=dtype),
                         nn.BatchNorm2d(out_channels, eps=1e-5))

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        return batch_norm(self[1], self[0](x), stats)


class ResNetBottleneck(nn.Module):
    """Bottleneck with the stride on the 3x3 (network_blocks.py:292). As
    the reference, ConvBn3 applies the activation before the residual
    add, and the activation runs once more after it."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, groups: int = 1, base_width: int = 64,
                 act: str = "relu", expansion: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * expansion
        self.ConvBn1 = BaseConv(in_channels, width, 1, 1, groups, act=act, dtype=dtype)
        self.ConvBn2 = BaseConv(width, width, 3, stride, groups, act=act, dtype=dtype)
        self.ConvBn3 = BaseConv(width, out, 1, 1, groups, act=act, dtype=dtype)
        self.downsample = ConvBN(in_channels, out, stride, dtype) if has_downsample else None
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        y = self.ConvBn3(self.ConvBn2(self.ConvBn1(x, stats), stats), stats)
        identity = x if self.downsample is None else self.downsample(x, stats)
        return self.act(y + identity)


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

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        x1 = run(self.m, self.conv1(x, stats), stats)
        x2 = self.conv2(x, stats)
        return self.conv3(torch.cat([x1, x2], 1), stats)


class Focus(nn.Module):
    """Space-to-depth stem (network_blocks.py:267).

    Takes the raw (F, H, W, 3) image (fp32, or uint8 at bf16). With
    eval-mode BN, BN folds into scale/shift as in blocks.py:580-598; with
    ksize 3, stride 1 and SiLU the stem (6x6/s2 conv + shift + SiLU) runs
    as the hand kernel `ops.kernels.focus_stem`, differentiable in the
    weights and BN parameters (its backward is JAX's `_bwd`, a plain
    recompute); its plain version does s2d + the 3x3 conv. Any other
    ksize, stride or activation takes JAX's own route for it, where no
    Pallas kernel runs either (blocks.py:596-598): the (2k)x(2k)/(2s) conv
    in the compute dtype, then scale and shift in fp32, then the
    activation. With train-mode BN (`stats` given) JAX's Focus runs that
    conv, then BatchNorm, then the activation (blocks.py:573-577), and so
    does this one, with no kernel launch. The parameters are the
    reference's (`stem.conv.conv.weight` (O, 4C, k, k), `stem.conv.bn.*`)
    and stay fp32 at any compute dtype: at bf16 the kernel rounds the
    BN-folded weights to bf16 itself and writes bf16, as the Pallas kernel
    does (focus_stem.py:144-148), and the XLA-route conv casts the image
    and the (2k)x(2k) weights to bf16, as `_conv6` does. After
    `fuse_model` the conv's bias is the shift and the scale is 1."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if ksize % 2 != 1:
            raise ValueError("the Focus stem's fused conv takes an odd ksize")
        self.dtype = dtype
        self.ksize, self.stride = ksize, stride
        self.kernel = (ksize, stride, act) == (3, 1, "silu")
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride,
                             act=act)

    def _conv6(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's `_conv6`: the s2d + kxk conv as one (2k)x(2k) conv of
        stride 2s over the NHWC image, in the compute dtype."""
        w6 = rearrange_weight(self.conv.conv.weight).to(self.dtype)
        return F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), w6,
                        stride=2 * self.stride, padding=self.ksize - 1)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        conv, bn = self.conv.conv, self.conv.bn
        if stats is not None:
            if bn is None:
                raise ValueError("train-mode BatchNorm on a model with BN folded")
            return self.conv.act(batch_norm(bn, self._conv6(x), stats))
        if bn is None:
            shift = conv.bias
            scale = torch.ones_like(shift)
        else:
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
        if self.kernel:
            return focus_stem(x, conv.weight, scale, shift, out_dtype=self.dtype)
        y = self._conv6(x).float() * scale[:, None, None] + shift[:, None, None]
        return self.conv.act(y.to(self.dtype))
