"""Layer zoo (counterpart of tscd_tpu/models/custom_layers.py; reference
custom_layers.py: MyDCNv2:88, CoordConv:664, DropBlock:839). NCHW in and
out. The deformable conv is bilinear gathers over offset grids and a
dense projection, as JAX's (no library deformable-conv op: its sampling
rule differs, `_bilinear_gather`); DropBlock expands its dropped seeds
with a max-pool."""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(x: torch.Tensor, k: int, value: float = 0.0) -> torch.Tensor:
    """flax's "SAME" padding at stride 1: (k - 1) // 2 before, k // 2 after."""
    lo, hi = (k - 1) // 2, k // 2
    return F.pad(x, (lo, hi, lo, hi), value=value)


class CoordConv(nn.Module):
    """(custom_layers.py:664) the normalized x and y coordinates (linspace
    -1..1 over W and H) concatenated after the channels, then a conv with
    "SAME" padding and a bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels + 2, out_channels, kernel_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        dt = self.conv.weight.dtype
        gy = torch.linspace(-1.0, 1.0, H, dtype=dt, device=x.device)
        gx = torch.linspace(-1.0, 1.0, W, dtype=dt, device=x.device)
        xx = gx[None, None, None, :].expand(B, 1, H, W).to(x.dtype)
        yy = gy[None, None, :, None].expand(B, 1, H, W).to(x.dtype)
        x = torch.cat([x, xx, yy], 1).to(dt)
        return self.conv(_same_pad(x, self.conv.kernel_size[0]))


class DropBlock(nn.Module):
    """(custom_layers.py:839) structured dropout: in train mode, seeds drawn
    with probability gamma, each grown to a block_size square (a "SAME"
    max-pool), the rest kept and scaled by all / kept. Eval mode (or
    keep_prob 1) is the identity."""

    def __init__(self, block_size: int = 3, keep_prob: float = 0.9):
        super().__init__()
        self.block_size, self.keep_prob = block_size, keep_prob

    def gamma(self, H: int, W: int) -> float:
        k = self.block_size
        return ((1.0 - self.keep_prob) / k ** 2 * (H * W)
                / max((H - k + 1) * (W - k + 1), 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.keep_prob >= 1.0:
            return x
        seed = torch.rand(x.shape, generator=generator, device=x.device) < self.gamma(
            *x.shape[2:])
        return self.drop(x, seed)

    def drop(self, x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """x with the blocks around `seed` (a bool mask of x's shape)
        dropped and the rest scaled."""
        k = self.block_size
        block = F.max_pool2d(_same_pad(seed.float(), k, -float("inf")), k, 1)
        keep = 1.0 - block
        scale = keep.numel() / keep.sum().clamp(min=1.0)
        return x * keep.to(x.dtype) * scale.to(x.dtype)


def _bilinear_gather(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C); py, px (B, ...) positions -> (B, ..., C). Each corner
    index is clamped to the map's edge, and only samples wholly outside
    (-1, H) x (-1, W) are zero (JAX's rule, not torchvision's)."""
    B, H, W, C = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    flat = x.reshape(B, H * W, C)

    def at(yi, xi):
        idx = yi.long().clamp(0, H - 1) * W + xi.long().clamp(0, W - 1)
        got = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
        return got.reshape(*idx.shape, C)

    valid = ((py > -1) & (py < H) & (px > -1) & (px < W))[..., None]
    out = (at(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + at(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + at(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + at(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    return torch.where(valid, out, torch.zeros_like(out))


class DeformConv2d(nn.Module):
    """DCNv2 (custom_layers.py MyDCNv2:88): a "SAME" conv predicts k x k
    offsets (dy, dx) and modulation masks (sigmoid), zero-initialised as
    JAX's; the features are sampled by `_bilinear_gather` in fp32 at each
    tap's offset position, masked, and `proj` maps the (k k major, C
    minor) samples to the output channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.k = k
        self.offset_conv = nn.Conv2d(in_channels, 3 * k * k, k, dtype=dtype)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.proj = nn.Linear(k * k * in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        k, dt = self.k, self.proj.weight.dtype
        off = self.offset_conv(_same_pad(x.to(dt), k)).permute(0, 2, 3, 1)  # (B, H, W, 3kk)
        offsets = off[..., :2 * k * k].reshape(B, H, W, k * k, 2)
        mask = torch.sigmoid(off[..., 2 * k * k:])
        f32 = dict(dtype=torch.float32, device=x.device)
        yy, xx = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
        d = torch.arange(k, **f32) - (k - 1) / 2
        dy, dx = torch.meshgrid(d, d, indexing="ij")
        py = (yy[..., None] + dy.reshape(-1))[None] + offsets[..., 0]
        px = (xx[..., None] + dx.reshape(-1))[None] + offsets[..., 1]
        sampled = _bilinear_gather(x.permute(0, 2, 3, 1).float(), py, px)  # (B, H, W, kk, C)
        sampled = (sampled * mask[..., None]).reshape(B, H, W, k * k * C).to(dt)
        return self.proj(sampled).permute(0, 3, 1, 2)
