"""The train steps (counterpart of tscd_tpu/train/step.py): the still-image
YOLOX step (`yolox_train_step`, make_yolox_train_step), and the stage-2
step (`train_step`, make_tscd_train_step and the step of
tscd_tpu/core/tscd_trainer.py:149-252): forward, loss, backward, grouped
SGD, EMA. In the stage-2 step the matcher starts each window from a fresh
state (resume=False), and within a window its bank carries gradients
across the local frames."""

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Union

import torch

from ..models.tscd import TSCD
from ..models.yolox import YOLOX
from .ema import ModelEMA
from .losses import tscd_loss, yolox_loss
from .optim import GroupedSGD


@dataclass
class TrainState:
    """The model (its parameters and buffers), the optimizer (its
    momentum, update count and the fp32 masters of a bf16 model) and the
    EMA."""
    model: Union[TSCD, YOLOX]
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


def init_train_state(model: Union[TSCD, YOLOX], optimizer: GroupedSGD,
                     ema_decay: float = 0.9998) -> TrainState:
    return TrainState(model, optimizer, ModelEMA(model, ema_decay, optimizer.masters))


def tscd_window_loss(model: TSCD, frames: torch.Tensor, labels: torch.Tensor,
                     time_emb: torch.Tensor, lframe: int, gframe: int, train: bool,
                     strides: Sequence[int], ota_mode: bool):
    """One window's forward and TSCD losses: (losses, the head's dict)."""
    # labels ride into the forward as JAX's fix_bn and train-mode steps
    # pass them (a cat_ota_fg head runs SimOTA there, once a window)
    out = model(frames, time_emb, lframe, gframe, train=train, labels=labels)
    return tscd_loss(out, labels, strides, lframe, ota_mode=ota_mode), out


def train_step(state: TrainState, frames: torch.Tensor, labels: torch.Tensor,
               time_emb: torch.Tensor, lframe: int, gframe: int,
               strides: Sequence[int] = (8, 16, 32), ota_mode: bool = True,
               fix_bn: bool = True,
               window_loss: Callable = tscd_window_loss) -> Dict[str, torch.Tensor]:
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
    result, so it takes no grad_accum.

    `window_loss(model, frames, labels, time_emb, lframe, gframe, train,
    strides, ota_mode)` -> (losses, the head's dict) is one window's
    forward and loss: the TSCD one, or the YOLOV family's
    (`core.yolov_trainer.yolov_window_loss`)."""
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
        losses, out = window_loss(model, frames[b], labels[b], time_emb[b], lframe, gframe,
                                  not fix_bn, strides, ota_mode)
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


def yolox_train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                     strides: Sequence[int] = (8, 16, 32), use_l1: bool = False,
                     grad_accum: int = 1) -> Dict[str, torch.Tensor]:
    """One still-image update (make_yolox_train_step): images (B, H, W, 3)
    fp32 or uint8 and labels (B, G, 5) [cls, cx, cy, w, h] on the model's
    device; BatchNorm in train mode (flax's), the new running statistics
    written, grouped SGD, then the EMA of the parameters and statistics.
    Returns the loss terms as device scalars.

    `grad_accum` k splits the batch into k chunks in order, as
    scan_accum_value_and_grad does: each chunk's forward (BN on the
    chunk's statistics, from the same running ones) and its backward of
    loss / k, one chunk live at a time; the gradients sum, and the losses
    and new statistics are the chunks' means."""
    model = state.model
    B = images.shape[0]
    if B % grad_accum:
        raise ValueError(f"grad_accum({grad_accum}) must divide the batch ({B})")
    n = B // grad_accum
    model.train()
    model.zero_grad(set_to_none=True)
    sums: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}
    for c in range(grad_accum):
        out = model(images[c * n:(c + 1) * n], train=True, decode=False)
        losses = yolox_loss(out["outputs"], labels[c * n:(c + 1) * n], out["hw"], strides,
                            use_l1=use_l1)
        total = losses["total_loss"]
        (total / grad_accum if grad_accum > 1 else total).backward()
        for k, v in losses.items():
            sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        for k, v in out["batch_stats"].items():
            stats[k] = stats[k] + v if k in stats else v
        del out, losses, total
    state.optimizer.step()
    with torch.no_grad():
        buffers = dict(model.named_buffers())
        for k, v in stats.items():
            buffers[k].copy_(v / grad_accum)
    state.ema.update(model, state.step, state.optimizer.masters)
    return {k: v / grad_accum for k, v in sums.items()}
