"""Haar DWT/IDWT and the high-frequency edge block (counterpart of
tscd_tpu/ops/wavelets.py), NCHW.

With a=TL, b=TR, c=BL, d=BR of each 2x2 block:
  LL = (a + b + c + d) / 2     LH = (a + b - c - d) / 2
  HL = (a - b + c - d) / 2     HH = (a - b - c + d) / 2
The band SIGNS matter: filter1 acts on the raw HF bands before a ReLU.
The edge block runs in its compute dtype (`dtype`), as the JAX block's
convs do.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def haar_dwt2d(x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (LL, LH, HL, HH) each (B, C, H/2, W/2)."""
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    return ((a + b + c + d) * 0.5, (a + b - c - d) * 0.5,
            (a - b + c - d) * 0.5, (a - b - c + d) * 0.5)


def haar_idwt2d(ll: torch.Tensor, lh: torch.Tensor, hl: torch.Tensor,
                hh: torch.Tensor) -> torch.Tensor:
    """Inverse of haar_dwt2d: 4 bands (B, C, h, w) -> (B, C, 2h, 2w)."""
    a = (ll + lh + hl + hh) * 0.5
    b = (ll + lh - hl - hh) * 0.5
    c = (ll - lh + hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    B, C, h, w = ll.shape
    top = torch.stack([a, b], -1)                  # (B, C, h, w, 2)
    bottom = torch.stack([c, d], -1)
    out = torch.stack([top, bottom], 3)            # (B, C, h, 2, w, 2)
    return out.reshape(B, C, 2 * h, 2 * w)


class WaveletsHFBlock(nn.Module):
    """Edge-feature extractor on the reg branch (reference
    surrounding_extraction.py:215): zero the LF band, 1x1 conv + ReLU on
    the HF bands, inverse transform, gate a 3x3-conv'd content map."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.filter1 = nn.Sequential(
            nn.Conv2d(3 * channels, 3 * channels, 1, dtype=dtype), nn.ReLU())
        self.filter2 = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        # odd maps are edge-padded so the 2x2 blocks tile, then cropped
        xp = F.pad(x, (0, W % 2, 0, H % 2), mode="replicate") \
            if (H % 2 or W % 2) else x
        ll, lh, hl, hh = haar_dwt2d(xp)
        hf = self.filter1(torch.cat([lh, hl, hh], 1))
        lh2, hl2, hh2 = torch.chunk(hf, 3, 1)
        edge = haar_idwt2d(torch.zeros_like(ll), lh2, hl2, hh2)[..., :H, :W]
        return self.filter2(x) * edge
