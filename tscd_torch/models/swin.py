"""Swin Transformer backbone (counterpart of tscd_tpu/models/swin.py;
reference swin_transfomer.py:457 SwinTransformer, WindowAttention:70,
BasicLayer:314, PatchMerging).

Takes the raw (F, H, W, 3) image (fp32, or uint8, cast exactly to the
compute dtype: 0-255, no normalisation, as the reference feeds its
Swin) and returns {"dark3", "dark4", "dark5"}, the stride 8/16/32 maps,
NCHW. Inside it is channels-last (B, H, W, C), as JAX's.

The window follows JAX's rule (swin.py:110-111): a block's window is
ws = min(window_size, H, W) of its unpadded map, shifted only where ws
is the full window; the map is padded at the bottom and right to a
multiple of ws before the roll and cropped after, and the shifted
windows' mask (-100 between regions) is built over the padded map. The
mask and the relative-position index are built once per shape and
device (`_static`): a forward inside a captured CUDA graph copies
nothing from the host. That cache is module-wide and never freed: a
captured graph reads its tensors for as long as the graph lives, which
may be longer than the model that built them. Each new frame size adds
its masks to it (about 6 MB on the card for a 576 px frame of Swin's
window 7, each stage's padded map at 4 bytes a (query, key) pair).

Parameter names are the reference's (`patch_embed.proj`,
`layers.{i}.blocks.{b}.attn.qkv`, `layers.{i}.downsample.reduction`,
`norm{i}`). The relative-position table is the reference's
((2 window_size - 1)^2, heads) at every map size: where JAX's window
shrinks (ws < window_size, maps under 7 px), JAX sizes its table to
(2 ws - 1)^2, and the port reads the same offsets from the table's
central block (`relative_position_index(ws, window_size)`), where
`utils.convert` carries such a table, and cuts it back out for JAX's
tree at a given frame size.

Compute dtype as JAX's `dtype`: the convs and Linear layers in it;
LayerNorms keep fp32 parameters and statistics and write the compute
dtype; the attention logits, the relative-position bias, the mask and
the softmax are fp32, and at bf16 only `attn @ v` reads bf16
(swin.py:60-79). LayerNorm eps is 1e-5, the output norms' flax's
default 1e-6 (swin.py:197-199; the reference's torch uses 1e-5). GELU
is erf-exact. No Pallas kernel runs in JAX's Swin: its attention is
plain einsums, and so is the port's.
"""

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_STATIC: Dict[tuple, torch.Tensor] = {}


def _static(key: tuple, device: torch.device, make: Callable[[], np.ndarray]) -> torch.Tensor:
    """The shape-static tensor `make()` on `device`, built at its first
    use and then read from this cache. While torch.export or torch.compile
    traces, it is built and not cached: the traced program keeps it as a
    constant of its own, and a cached tracing tensor would reach later
    eager calls."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(make(), device=device)
    k = key + (str(device),)
    t = _STATIC.get(k)
    if t is None:
        t = _STATIC[k] = torch.as_tensor(make(), device=device)
    return t


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm(dtype=dtype): statistics and normalisation in fp32
    on fp32 parameters, the result in `dtype`."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax's Dense(dtype=...): the input cast to the weights' dtype."""
    return F.linear(x.to(lin.weight.dtype), lin.weight, lin.bias)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C)."""
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int, table_ws: Optional[int] = None) -> np.ndarray:
    """(N, N) row of the relative-position table of each (query, key)
    pair of a ws x ws window, N = ws^2: JAX's index (swin.py:33-42) over
    a table for windows of `table_ws` (ws by default, as JAX sizes it;
    a larger table's central block otherwise)."""
    t = ws if table_ws is None else table_ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (t - 1)
    return rel[:, :, 0] * (2 * t - 1) + rel[:, :, 1]


def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) mask of the shifted windows over an H x W (padded) map:
    -100 between pixels of different regions (swin_transfomer.py:215)."""
    img_mask = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)

    def bias(self, ws: int, device: torch.device) -> torch.Tensor:
        """(h, N, N) fp32 relative-position bias of a ws x ws window."""
        idx = _static(("rel_index", ws, self.window_size), device, lambda: relative_position_index(
            ws, self.window_size).reshape(-1))
        N = ws * ws
        return self.relative_position_bias_table[idx].view(N, N, -1).permute(2, 0, 1).float()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (nW * B, N, C), N = ws^2; mask (nW, N, N) or None."""
        Bn, N, C = x.shape
        h = self.num_heads
        ws = int(round(N ** 0.5))
        qkv = dense(self.qkv, x).view(Bn, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                            # (Bn, h, N, d)
        q = q * (C // h) ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        attn = attn + self.bias(ws, x.device)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.view(Bn // nW, nW, h, N, N) + mask[None, :, None]).view(Bn, h, N, N)
        attn = torch.softmax(attn, -1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(Bn, N, C)
        return dense(self.proj, out)


class Mlp(nn.Module):
    """fc1, erf GELU, fc2 (`mlp.fc1`, `mlp.fc2`; FocalNet's too)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.fc2, F.gelu(dense(self.fc1, x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.shift_size, self.dtype = window_size, shift_size, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C)."""
        B, H, W, C = x.shape
        ws = min(self.window_size, H, W)
        shift = self.shift_size if ws == self.window_size else 0
        shortcut = x
        x = layer_norm(self.norm1, x, self.dtype)
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = _static(("shift_mask", Hp, Wp, ws, shift), x.device,
                           lambda: shift_attn_mask(Hp, Wp, ws, shift))
        wins = self.attn(window_partition(x, ws).reshape(-1, ws * ws, C), mask)
        x = window_reverse(wins.view(-1, ws, ws, C), ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = shortcut + x[:, :H, :W]
        return x + self.mlp(layer_norm(self.norm2, x, self.dtype))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C); the channels in
        the order [(h0,w0), (h1,w0), (h0,w1), (h1,w1)] (swin.py:150-158)."""
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = x.shape[1], x.shape[2]
        x = x.view(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5).reshape(
            B, H // 2, W // 2, 4 * C)
        return dense(self.reduction, layer_norm(self.norm, x, self.dtype))


class PatchEmbed(nn.Module):
    """4 x 4 stride-4 conv, then LayerNorm (`patch_embed.proj`, `.norm`)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, 4, 4, dtype=dtype)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class BasicLayer(nn.Module):
    """A stage: `blocks` (every second one shifted), then `downsample`
    (PatchMerging) but in the last stage."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, mlp_ratio: float,
                 downsample: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, window_size // 2 if b % 2 else 0, mlp_ratio,
                      dtype) for b in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None


STAGE_NAMES = {0: "dark2", 1: "dark3", 2: "dark4", 3: "dark5"}


class SwinTransformer(nn.Module):
    """Swin-T/S/B by (embed_dim, depths, num_heads); `channels` the
    dark3/dark4/dark5 maps' channels (the neck's inputs)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, out_indices: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim, dtype)
        n = len(depths)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window_size, mlp_ratio,
                       i < n - 1, dtype) for i in range(n))
        for i in self.out_indices:
            setattr(self, f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=1e-6))
        self.channels = tuple(embed_dim * 2 ** i for i in self.out_indices)

    def forward(self, x: torch.Tensor, stats=None) -> Dict[str, torch.Tensor]:
        """x (F, H, W, 3) raw image; `stats` (the BN mode) is unused:
        Swin has no BatchNorm."""
        dt = self.dtype
        pe = self.patch_embed
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), pe.proj.weight, pe.proj.bias, 4)
        x = layer_norm(pe.norm, x.permute(0, 2, 3, 1), dt)
        outs = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x)
            if i in self.out_indices:
                y = layer_norm(getattr(self, f"norm{i}"), x, dt)
                outs[STAGE_NAMES[i]] = y.permute(0, 3, 1, 2).contiguous()
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


def swin_tiny(**kw) -> SwinTransformer:
    return SwinTransformer(96, (2, 2, 6, 2), (3, 6, 12, 24), **kw)


def swin_small(**kw) -> SwinTransformer:
    return SwinTransformer(96, (2, 2, 18, 2), (3, 6, 12, 24), **kw)


def swin_base(**kw) -> SwinTransformer:
    return SwinTransformer(128, (2, 2, 18, 2), (4, 8, 16, 32), **kw)
