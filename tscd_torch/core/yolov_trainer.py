"""YOLOV / YOLOV++ trainer and predict function of the port (counterpart
of tscd_tpu/core/yolov_trainer.py): the stage-2 trainer (`TSCDTrainer`:
loader, window batches, fix_bn, SGD groups, EMA, checkpoints) with the
YOLOV forward (no matcher; YOLOV takes no time embedding, YOLOV++ takes
one) and `yolov_loss` over the refined frames: R = L + G for YOLOV or
where L = 0, else L (:53-54, the heads' own slicing).

`make_predict_fn` is the streaming evaluator's step, built as
`core.predict.make_predict_fn` builds TSCD's (`window_predict_fn`: one
CUDA graph a window on a card, `dispatch_eager` launch by launch,
`materialize` the R frames' detection rows). It runs the refined
postprocess only: JAX's predict function reads `refined` alone, and its
jit drops `original`.
"""

from typing import Dict, Tuple

import torch

from ..models.yolov import yolov_eval_postprocess
from ..ops.postprocess import Detections
from ..train.losses import yolov_loss
from ..train.step import train_step
from .predict import window_predict_fn
from .tscd_trainer import TSCDTrainer


def yolov_forward(model, x, lframe: int, gframe: int, time_emb, train: bool = False):
    """The model's forward with JAX's signature of its class
    (yolov_trainer.py:16-26): YOLOV takes no time embedding."""
    if model.takes_time_embedding:
        return model(x, lframe, gframe, time_emb, train=train)
    return model(x, lframe, gframe, train=train)


def yolov_window_loss(model, frames, labels, time_emb, lframe, gframe, train, strides,
                      ota_mode):
    """One window's forward and YOLOV losses (`train.step.train_step`'s
    window_loss): the refined frames as the model's head refines them."""
    out = yolov_forward(model, frames, lframe, gframe, time_emb, train)
    return yolov_loss(out, labels, strides, model.refined_frames(lframe, gframe)), out


class YOLOVTrainer(TSCDTrainer):
    """TSCDTrainer with the YOLOV window loss (`_window_losses`,
    yolov_trainer.py:41-66); it evaluates through the exp's predict
    function (`YOLOVExp.get_predict_fn`)."""

    def step(self, frames, labels, te) -> Dict[str, torch.Tensor]:
        return train_step(self.state, frames, labels, te, self.lframe, self.gframe,
                          fix_bn=self.exp.fix_bn, window_loss=yolov_window_loss)


def make_predict_fn(model, lframe: int, gframe: int, nms_thresh: float = 0.5,
                    conf_thre: float = 0.001):
    """predict(imgs, te, resume, state) -> (per-frame detection rows of
    the R refined frames, None: no matcher, no state), with `dispatch`,
    `dispatch_eager` and `materialize` (`core.predict.window_predict_fn`).
    A window of fewer frames than R (a short video's) gives its own
    frames' rows."""
    C = model.num_classes
    R = model.refined_frames(lframe, gframe)

    @torch.no_grad()
    def run(x: torch.Tensor, t: torch.Tensor) -> Tuple[Detections, None]:
        out = yolov_forward(model, x, lframe, gframe, t)
        return yolov_eval_postprocess(out, R, C, nms_thresh, conf_thre, original=False)[0], None

    def inputs(imgs, te, resume, state):
        return torch.as_tensor(imgs), torch.as_tensor(te, dtype=torch.float32)

    return window_predict_fn(run, inputs, model.device)
