"""One stage-2 train step (counterpart of tscd_tpu/train/step.py:
make_tscd_train_step and the window_batch = 1 step of
tscd_tpu/core/tscd_trainer.py:149-252): forward with fix_bn, tscd_loss,
backward, grouped SGD, EMA. The matcher starts each window from a fresh
state (resume=False), and within a window its bank carries gradients
across the local frames."""

from dataclasses import dataclass
from typing import Dict, Sequence

import torch

from ..models.tscd import TSCD
from .ema import ModelEMA
from .losses import tscd_loss
from .optim import GroupedSGD


@dataclass
class TrainState:
    """The model (its parameters and buffers), the optimizer (its
    momentum and update count) and the EMA."""
    model: TSCD
    optimizer: GroupedSGD
    ema: ModelEMA

    @property
    def step(self) -> int:
        """Updates made: the LR schedule's argument before an update, the
        EMA's clock after it."""
        return self.optimizer.count


def init_train_state(model: TSCD, optimizer: GroupedSGD,
                     ema_decay: float = 0.9998) -> TrainState:
    return TrainState(model, optimizer, ModelEMA(model, ema_decay))


def train_step(state: TrainState, frames: torch.Tensor, labels: torch.Tensor,
               time_emb: torch.Tensor, lframe: int, gframe: int,
               strides: Sequence[int] = (8, 16, 32),
               ota_mode: bool = True) -> Dict[str, torch.Tensor]:
    """One update on one window: frames (F, H, W, 3) fp32 or uint8,
    labels (F, G, 5) [cls, cx, cy, w, h], time_emb (F, 256), all on the
    model's device. Returns the loss terms as device scalars (no host
    read here)."""
    model = state.model
    model.train()
    out = model(frames, time_emb, lframe, gframe)
    losses = tscd_loss(out, labels, strides, lframe, ota_mode=ota_mode)
    model.zero_grad(set_to_none=True)
    losses["total_loss"].backward()
    state.optimizer.step()
    state.ema.update(model, state.step)
    return {k: v.detach() for k, v in losses.items()}
