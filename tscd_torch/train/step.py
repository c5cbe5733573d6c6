"""One stage-2 train step (counterpart of tscd_tpu/train/step.py:
make_tscd_train_step and the step of tscd_tpu/core/tscd_trainer.py:
149-252): forward, tscd_loss, backward, grouped SGD, EMA, over one
window or a batch of B windows. The matcher starts each window from a
fresh state (resume=False), and within a window its bank carries
gradients across the local frames."""

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
    momentum, update count and the fp32 masters of a bf16 model) and the
    EMA."""
    model: TSCD
    optimizer: GroupedSGD
    ema: ModelEMA

    @property
    def step(self) -> int:
        """Updates made: the LR schedule's argument before an update, the
        EMA's clock after it."""
        return self.optimizer.count

    def model_state(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict with fp32 masters in place of bf16
        parameters: what JAX's state holds, and what a checkpoint saves."""
        return {**self.model.state_dict(), **self.optimizer.masters}


def init_train_state(model: TSCD, optimizer: GroupedSGD,
                     ema_decay: float = 0.9998) -> TrainState:
    return TrainState(model, optimizer, ModelEMA(model, ema_decay, optimizer.masters))


def train_step(state: TrainState, frames: torch.Tensor, labels: torch.Tensor,
               time_emb: torch.Tensor, lframe: int, gframe: int,
               strides: Sequence[int] = (8, 16, 32), ota_mode: bool = True,
               fix_bn: bool = True) -> Dict[str, torch.Tensor]:
    """One update on one window, frames (F, H, W, 3) fp32 or uint8, labels
    (F, G, 5) [cls, cx, cy, w, h], time_emb (F, 256), or on a batch of B
    windows with a leading B axis on each; all on the model's device.
    Returns the loss terms as device scalars, each the mean over the
    windows (no host read here).

    As JAX's vmapped step, the loss is the mean over the B windows of each
    window's loss; here the windows run one at a time, each forward
    followed by its backward (of loss / B), so one window's activations
    are live at a time, and the gradients sum over the windows (in fp32:
    `GroupedSGD.accumulate` after each). With `fix_bn` every BN uses its
    running statistics, which stay as they are; without it BN runs in
    train mode, each window's new statistics computed from the same old
    ones, and the new state is their mean (tscd_trainer.py:198-214),
    which the EMA then follows.

    JAX's `grad_accum` (which must divide B, `exp.check_train_knobs`)
    scans its vmapped loss over chunks of windows to cut peak memory, with
    the one-big-batch result (`scan_accum_value_and_grad`); this step
    holds one window at a time whatever the chunking and gives that
    result, so it takes no grad_accum."""
    model = state.model
    batched = frames.dim() == 5
    if not batched:
        frames, labels, time_emb = frames[None], labels[None], time_emb[None]
    B = frames.shape[0]
    model.train()
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}
    for b in range(B):
        # labels ride into the forward as JAX's fix_bn and train-mode steps
        # pass them (a cat_ota_fg head runs SimOTA there, once a window)
        out = model(frames[b], time_emb[b], lframe, gframe, train=not fix_bn,
                    labels=labels[b])
        losses = tscd_loss(out, labels[b], strides, lframe, ota_mode=ota_mode)
        total = losses["total_loss"]
        (total / B if B > 1 else total).backward()
        state.optimizer.accumulate()
        for k, v in losses.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        for k, v in out.get("batch_stats", {}).items():
            stats[k] = stats[k] + v if k in stats else v
        del out, losses, total
    state.optimizer.step()
    if stats:
        with torch.no_grad():
            buffers = dict(model.named_buffers())
            for k, v in stats.items():
                buffers[k].copy_(v / B)
    state.ema.update(model, state.step, state.optimizer.masters)
    return {k: v / B for k, v in sums.items()}
