"""Level flattening of the YOLOX head outputs (counterpart of
tscd_tpu/models/yolo_head.py:flatten_levels)."""

from typing import Sequence

import torch


def flatten_levels(level_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, K, H, W) ...] NCHW -> (B, sum(H*W), K), anchors in raster
    order within each level and levels in stride order: the JAX package
    flattens NHWC, so the maps go to (B, H, W, K) before the reshape."""
    return torch.cat([o.permute(0, 2, 3, 1).reshape(o.shape[0], -1, o.shape[1])
                      for o in level_outputs], 1)
