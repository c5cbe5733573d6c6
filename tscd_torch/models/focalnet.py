"""FocalNet backbone (counterpart of tscd_tpu/models/focalnet.py;
reference focal.py: FocalNet:336, FocalModulation:37,
FocalModulationBlock:111, PatchEmbed:292, build_focalnet:501).

Focal modulation: per level l a depthwise k x k conv (k = 2 l +
focal_window, padded k // 2 each side) and GELU over the context, each
level gated into the sum; the GELU of the last level's spatial mean,
gated, joins it; a 1 x 1 conv with bias (`h`) of the sum multiplies the
query. No attention and no Pallas kernel in JAX, plain tensor ops here.

Takes the raw (F, H, W, 3) image (fp32, or uint8 cast exactly to the
compute dtype) and returns {"dark3", "dark4", "dark5"}, NCHW; inside it
is channels-last, as JAX's, and the depthwise convs read the context as
NCHW. Parameter names are the reference's (`patch_embed.proj`,
`layers.{i}.blocks.{b}.modulation.focal_layers.{l}.0`, `gamma_1`,
`layers.{i}.downsample.proj`, `norm{i}`).

Compute dtype as JAX's `dtype`: convs and Linear layers in it, the
LayerNorms' statistics fp32 and their result in it; the layerscale
gammas are fp32 parameters, so at bf16 the residual stream after a
block's first add is fp32, as JAX's type promotion makes it. Every
LayerNorm's eps is 1e-5. GELU is erf-exact.
"""

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .swin import STAGE_NAMES, Mlp, dense, layer_norm


class FocalModulation(nn.Module):
    def __init__(self, dim: int, focal_level: int = 2, focal_window: int = 9,
                 focal_factor: int = 2, use_postln_in_modulation: bool = False,
                 normalize_modulator: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.focal_level, self.dtype = dim, focal_level, dtype
        self.normalize_modulator = normalize_modulator
        self.f = nn.Linear(dim, 2 * dim + focal_level + 1, dtype=dtype)
        self.h = nn.Conv2d(dim, dim, 1, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)
        self.focal_layers = nn.ModuleList()
        for l in range(focal_level):
            k = focal_factor * l + focal_window
            self.focal_layers.append(nn.Sequential(
                nn.Conv2d(dim, dim, k, groups=dim, padding=k // 2, bias=False, dtype=dtype),
                nn.GELU()))
        self.ln = nn.LayerNorm(dim, eps=1e-5) if use_postln_in_modulation else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H, W, C) in the compute dtype."""
        C, L = self.dim, self.focal_level
        q, ctx, gates = dense(self.f, x).split([C, C, L + 1], -1)
        ctx = ctx.permute(0, 3, 1, 2).contiguous()
        gates = gates.permute(0, 3, 1, 2)
        ctx_all = 0.0
        for l, layer in enumerate(self.focal_layers):
            ctx = F.gelu(layer[0](ctx))
            ctx_all = ctx_all + ctx * gates[:, l:l + 1]
        ctx_global = F.gelu(ctx.mean((2, 3), keepdim=True))
        ctx_all = ctx_all + ctx_global * gates[:, L:L + 1]
        if self.normalize_modulator:
            ctx_all = ctx_all / (L + 1)
        out = q * self.h(ctx_all).permute(0, 2, 3, 1)
        if self.ln is not None:
            out = layer_norm(self.ln, out, self.dtype)
        return dense(self.proj, out)


class FocalBlock(nn.Module):
    """FocalModulationBlock (focal.py:111): pre- or post-LN residual block
    with optional per-channel layerscale (gammas start at 1e-4)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, focal_level: int = 2,
                 focal_window: int = 9, use_postln: bool = False,
                 use_postln_in_modulation: bool = False, use_layerscale: bool = False,
                 normalize_modulator: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_postln, self.dtype = use_postln, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.modulation = FocalModulation(dim, focal_level, focal_window,
                                          use_postln_in_modulation=use_postln_in_modulation,
                                          normalize_modulator=normalize_modulator, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        if use_layerscale:
            self.gamma_1 = nn.Parameter(torch.full((dim,), 1e-4))
            self.gamma_2 = nn.Parameter(torch.full((dim,), 1e-4))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln = lambda norm, z: layer_norm(norm, z, self.dtype)   # noqa: E731
        g1 = 1.0 if self.gamma_1 is None else self.gamma_1
        g2 = 1.0 if self.gamma_2 is None else self.gamma_2
        y = self.modulation(x if self.use_postln else ln(self.norm1, x))
        if self.use_postln:
            y = ln(self.norm1, y)
        x = x + g1 * y
        if self.use_postln:
            return x + g2 * ln(self.norm2, self.mlp(x))
        return x + g2 * self.mlp(ln(self.norm2, x))


class FocalPatchEmbed(nn.Module):
    """A conv then LayerNorm (`proj`, `norm`): the stem (k7 s4 pad 2 with
    `use_conv_embed`, else k4 s4) or a stage's downsample (k3 s2 pad 1,
    else k2 s2)."""

    def __init__(self, cin: int, cout: int, stem: bool, conv_embed: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_embed:
            k, s, p = (7, 4, 2) if stem else (3, 2, 1)
        else:
            k, s, p = (4, 4, 0) if stem else (2, 2, 0)
        self.dtype = dtype
        self.proj = nn.Conv2d(cin, cout, k, s, p, dtype=dtype)
        self.norm = nn.LayerNorm(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, cin) -> (B, H', W', cout) in the compute dtype."""
        y = self.proj(x.to(self.dtype).permute(0, 3, 1, 2))
        return layer_norm(self.norm, y.permute(0, 2, 3, 1), self.dtype)


class FocalLayer(nn.Module):
    """A stage: `blocks`, then `downsample` but in the last stage."""

    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class FocalNet(nn.Module):
    """FocalNet (focal.py:336); defaults the reference class's. `channels`
    the dark3/dark4/dark5 maps' channels (the neck's inputs)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 focal_levels: Sequence[int] = (3, 3, 3, 3),
                 focal_windows: Sequence[int] = (3, 3, 3, 3), mlp_ratio: float = 4.0,
                 use_conv_embed: bool = False, use_postln: bool = False,
                 use_postln_in_modulation: bool = False, use_layerscale: bool = False,
                 normalize_modulator: bool = False, out_indices: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_indices = tuple(out_indices)
        self.patch_embed = FocalPatchEmbed(3, embed_dim, True, use_conv_embed, dtype)
        n = len(depths)
        layers = []
        for i, depth in enumerate(depths):
            dim = embed_dim * 2 ** i
            blocks = [FocalBlock(dim, mlp_ratio, focal_levels[i], focal_windows[i], use_postln,
                                 use_postln_in_modulation, use_layerscale, normalize_modulator,
                                 dtype) for _ in range(depth)]
            down = (FocalPatchEmbed(dim, 2 * dim, False, use_conv_embed, dtype)
                    if i < n - 1 else None)
            layers.append(FocalLayer(blocks, down))
        self.layers = nn.ModuleList(layers)
        for i in self.out_indices:
            setattr(self, f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))
        self.channels = tuple(embed_dim * 2 ** i for i in self.out_indices)

    def forward(self, x: torch.Tensor, stats=None) -> Dict[str, torch.Tensor]:
        """x (F, H, W, 3) raw image; `stats` (the BN mode) is unused:
        FocalNet has no BatchNorm."""
        x = self.patch_embed(x)
        outs = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x)
            if i in self.out_indices:
                y = layer_norm(getattr(self, f"norm{i}"), x, self.dtype)
                outs[STAGE_NAMES[i]] = y.permute(0, 3, 1, 2).contiguous()
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


FOCALNET_CONFIGS = {
    "focalnet_tiny": dict(embed_dim=96, depths=(2, 2, 6, 2)),
    "focalnet_small": dict(embed_dim=96, depths=(2, 2, 18, 2)),
    "focalnet_base": dict(embed_dim=128, depths=(2, 2, 18, 2)),
    "focalnet_tscd": dict(embed_dim=192, depths=(2, 2, 6, 2), focal_levels=(4, 4, 4, 4),
                          focal_windows=(3, 3, 3, 3), use_conv_embed=True, use_postln=True,
                          use_layerscale=True),
    "focalnet_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2), focal_levels=(3, 3, 3, 3),
                               focal_windows=(5, 5, 5, 5), use_conv_embed=True,
                               use_postln=True, use_layerscale=True),
    "focalnet_L_384_22k_fl4": dict(embed_dim=192, depths=(2, 2, 18, 2),
                                   focal_levels=(4, 4, 4, 4), focal_windows=(3, 3, 3, 3),
                                   use_conv_embed=True, use_postln=True, use_layerscale=True),
}


def build_focalnet(variant: str = "focalnet_tiny", **kw) -> FocalNet:
    """A named variant (focalnet.py:177-199), `kw` over its config."""
    return FocalNet(**{**FOCALNET_CONFIGS[variant], **kw})
