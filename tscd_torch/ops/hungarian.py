"""On-device assignment (counterpart of tscd_tpu/ops/hungarian.py). The
solver itself is the hand kernel in ops/kernels/hungarian.py."""

import torch

from .kernels.hungarian import linear_sum_assignment

__all__ = ["linear_sum_assignment", "masked_linear_sum_assignment"]


def masked_linear_sum_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                                 col_valid: torch.Tensor,
                                 big: float = 1e4) -> torch.Tensor:
    """(n, n) cost; invalid rows/cols are steered to match each other:
    valid-valid pairs keep their cost, valid-invalid pairs cost `big`,
    invalid-invalid pairs cost 0. Returns col4row (n,) int32."""
    vv = row_valid[:, None] & col_valid[None, :]
    ii = (~row_valid[:, None]) & (~col_valid[None, :])
    cost = torch.where(vv, cost.to(torch.float32),
                       torch.where(ii, 0.0, big).to(torch.float32))
    return linear_sum_assignment(cost[None])[0]
