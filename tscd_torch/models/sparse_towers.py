"""Proposal-patch video towers (counterpart of
tscd_tpu/models/sparse_towers.py), NCHW and batched over the F x P
patches.

The dense path computes the extra video towers (`cls_convs2`,
`reg_convs2`) and the wavelet edge block over every anchor of every FPN
level, then gathers the P proposals of each frame. This path computes
them only on small patches around the proposals, with the dense path's
values:

- Each tower conv is the same module run with no padding (`valid=True`)
  on a patch of the zero-padded stem map; positions of every
  intermediate that lie outside the map are zeroed again, which gives
  the dense path's zero padding at the borders (BN's shift, or a folded
  bias, makes conv(0) nonzero there).
- The Haar DWT tiles 2x2 blocks anchored at even coordinates, so the reg
  patches are block-aligned: for a proposal at (y, x) the reg tower is
  evaluated on [2*floor((y-1)/2), +4) x [2*floor((x-1)/2), +4), which
  holds the 3x3 neighbourhood of (y, x) and its whole DWT block.
  `WaveletsHFBlock` then runs as it is on the 4x4 patch, and the (y, x)
  output, interior to the patch, is selected.
- Anchor ids run across levels; each level processes all P slots (a
  foreign proposal's coordinates clamped into the level) and the owning
  level's result is kept, so every shape is fixed (3x the patch work).

BatchNorm on patches would take other batch statistics than on the
maps, so the caller takes this path only with BN on its running
statistics (`stats is None`). Gathers are differentiable (their backward
a scatter-add), so a fix_bn training step trains through the patches,
as JAX's does.
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from .blocks import BNStats


def extract_patches(fmap: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                    size: int, pad: int) -> torch.Tensor:
    """(size x size) patches of the zero-padded map fmap (F, C, h, w) at
    origins oy/ox (F, P) in unpadded coordinates (in [-pad, h-1]) ->
    (F * P, C, size, size)."""
    Fr, C, h, w = fmap.shape
    P = oy.shape[1]
    wp = w + 2 * pad
    flat = nn.functional.pad(fmap, (pad, pad, pad, pad)).reshape(Fr, C, -1)
    ii = torch.arange(size, device=fmap.device)
    rows = (oy + pad)[..., None] + ii                        # (F, P, s)
    cols = (ox + pad)[..., None] + ii
    lin = (rows[..., :, None] * wp + cols[..., None, :]).reshape(Fr, 1, -1)
    out = torch.gather(flat, 2, lin.expand(Fr, C, lin.shape[-1]))
    return out.reshape(Fr, C, P, size, size).transpose(1, 2).reshape(
        Fr * P, C, size, size)


def inmap_mask(oy: torch.Tensor, ox: torch.Tensor, size: int, h: int, w: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(F * P, 1, size, size) mask of the patch positions inside [0, h) x
    [0, w): zeroing the rest gives the dense path's zero padding."""
    ii = torch.arange(size, device=oy.device)
    ry = oy[..., None] + ii
    rx = ox[..., None] + ii
    my = (ry >= 0) & (ry < h)
    mx = (rx >= 0) & (rx < w)
    m = my[..., :, None] & mx[..., None, :]
    return m.reshape(-1, 1, size, size).to(dtype)


def _pick(patches: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """patches (N, C, 4, 4), sel (N,) flat positions -> (N, C)."""
    N, C = patches.shape[:2]
    flat = patches.reshape(N, C, 16)
    return torch.gather(flat, 2, sel.view(N, 1, 1).expand(N, C, 1))[..., 0]


def sparse_vid_tower_features(
        stem_feats: Sequence[torch.Tensor],
        idx: torch.Tensor,
        cls_towers: Sequence[nn.Sequential],
        reg_towers: Sequence[nn.Sequential],
        edge_blocks: Sequence[nn.Module],
        lframe: int,
        edge_all_frames: bool,
        stats: BNStats = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The proposals' tower features without the dense tower maps.

    stem_feats: per level (F, hid, h_k, w_k); idx: (F, P) anchor ids in
    flatten_levels order; cls_towers/reg_towers: each level's two-conv
    Sequential; edge_blocks: each level's edge block. Returns (f_cls (F,
    P, hid), f_reg (F, P, hid), f_edge (F or lframe, P, hid)), the dense
    maps' rows at idx."""
    Fr, P = idx.shape
    hid = stem_feats[0].shape[1]
    dt = stem_feats[0].dtype
    Fe = Fr if edge_all_frames else lframe
    f_cls = f_reg = f_edge = None
    base = 0
    for k, x in enumerate(stem_feats):
        h, w = x.shape[2:]
        local = (idx - base).clamp(0, h * w - 1)
        own = ((idx >= base) & (idx < base + h * w)).to(dt)[..., None]
        base += h * w
        y = torch.div(local, w, rounding_mode="floor")
        xx = local - y * w
        c0, c1 = cls_towers[k]
        r0, r1 = reg_towers[k]

        # cls tower: 5x5 patch centred at (y, x) -> 3x3 -> 1x1
        pc = c0(extract_patches(x, y - 2, xx - 2, 5, 2), stats, valid=True)
        pc = pc * inmap_mask(y - 1, xx - 1, 3, h, w, dt)
        f_cls_k = c1(pc, stats, valid=True).reshape(Fr, P, hid)

        # reg tower: block-aligned 8x8 -> 6x6 -> 4x4
        sy = 2 * torch.div(y - 1, 2, rounding_mode="floor")  # even, in [-2, h-2]
        sx = 2 * torch.div(xx - 1, 2, rounding_mode="floor")
        pr = r0(extract_patches(x, sy - 2, sx - 2, 8, 4), stats, valid=True)
        pr = pr * inmap_mask(sy - 1, sx - 1, 6, h, w, dt)
        pr = r1(pr, stats, valid=True) * inmap_mask(sy, sx, 4, h, w, dt)
        sel = ((y - sy) * 4 + (xx - sx)).reshape(-1)           # dy, dx in {1, 2}
        f_reg_k = _pick(pr, sel).reshape(Fr, P, hid)

        # the edge block as it is on the aligned 4x4 reg patch
        ne = Fe * P
        f_edge_k = _pick(edge_blocks[k](pr[:ne]), sel[:ne]).reshape(Fe, P, hid)

        parts = (own * f_cls_k, own * f_reg_k, own[:Fe] * f_edge_k)
        if f_cls is None:
            f_cls, f_reg, f_edge = parts
        else:
            f_cls, f_reg, f_edge = (a + b for a, b in zip((f_cls, f_reg, f_edge), parts))
    return f_cls, f_reg, f_edge
