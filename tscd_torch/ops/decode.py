"""Grid decode for YOLOX-style dense predictions (counterpart of
tscd_tpu/ops/decode.py):
  xy = (pred_xy + grid_xy) * stride,  wh = exp(pred_wh) * stride."""

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def make_grids_and_strides(hw: Sequence[Tuple[int, int]],
                           strides: Sequence[int]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated (A, 2) grid coords and (A, 1) strides for all levels,
    in raster order within each level."""
    grids, strs = [], []
    for (h, w), s in zip(hw, strides):
        yv, xv = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([xv, yv], axis=-1).reshape(-1, 2).astype(np.float32)
        grids.append(grid)
        strs.append(np.full((grid.shape[0], 1), s, np.float32))
    return np.concatenate(grids, 0), np.concatenate(strs, 0)


def _make_grid_tensors(hw: Tuple[Tuple[int, int], ...], strides: Tuple[int, ...],
                       dtype: torch.dtype, device: torch.device):
    grids, strs = make_grids_and_strides(hw, strides)
    return (torch.as_tensor(grids, dtype=dtype, device=device),
            torch.as_tensor(strs, dtype=dtype, device=device))


# uploaded once per shape and device, not on every window
_cached_grid_tensors = functools.lru_cache(maxsize=16)(_make_grid_tensors)


def _grid_tensors(hw, strides, dtype, device):
    """The grids and strides as tensors. While torch.export or
    torch.compile traces they are built and not cached: the traced program
    keeps them as its own constants, and a cached tracing tensor would
    reach later eager calls."""
    if torch.compiler.is_compiling():
        return _make_grid_tensors(hw, strides, dtype, device)
    return _cached_grid_tensors(hw, strides, dtype, device)


def decode_outputs(outputs: torch.Tensor, hw: Sequence[Tuple[int, int]],
                   strides: Sequence[int]) -> torch.Tensor:
    """(B, A, 5+C) raw head output (reg4, obj, cls...) -> same shape with
    [..., :2] centre pixels and [..., 2:4] wh pixels; obj/cls pass
    through (the caller applies the sigmoid)."""
    grids, strs = _grid_tensors(tuple(map(tuple, hw)), tuple(strides),
                                outputs.dtype, outputs.device)
    xy = (outputs[..., :2] + grids) * strs
    wh = torch.exp(outputs[..., 2:4]) * strs
    return torch.cat([xy, wh, outputs[..., 4:]], -1)


def anchor_centers(hw: Sequence[Tuple[int, int]], strides: Sequence[int],
                   device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-anchor (x_shift, y_shift, stride), each (A,) fp32 on `device`
    (the CPU unless given), uploaded once per shape and device."""
    grids, strs = _grid_tensors(tuple(map(tuple, hw)), tuple(strides),
                                torch.float32, torch.device(device or "cpu"))
    return grids[:, 0], grids[:, 1], strs[:, 0]
