"""The online YOLOV path's streaming entry point (counterpart of the
`step` and `window_step` of tools/yolov_demo_online.py:78-103 and its
partial-batch rule, :145-169).

`OnlineStream` holds a `YOLOVOnline` model and its `OnlineBank`. A step
takes one frame, runs the model on it and the bank, keeps the refined
detections where the model's `use_refined` says the bank has taken part
(from the third frame on) and the still detector's before, and leaves
the new bank in place of the old. `window_step` does the same for K
frames in one program (the backbone batched over them, the head once a
frame), and `run_batch` is the demo's rule for a batch that the
FrameBatcher flushed: a full one goes through `window_step`, a partial
one frame by frame. (The demo pads a partial batch to K, runs the
window, then throws its outputs and its bank away and re-runs the frames
one by one; the padded window, whose every effect is discarded, is not
run here.)

On a card each step is one replayed CUDA graph (`core.predict.
WindowGraph`, captured at the first step of each frame shape, dtype and
K): the frame goes into a static buffer, and the bank's tensors are the
graph's static buffers, updated in place inside the graph, so the bank
never leaves the card and a step reads nothing back. CPU tensors take
the eager path (device="cpu").
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.yolov import YOLOVOnline, yolov_eval_postprocess
from ..ops.postprocess import Detections
from .predict import WindowGraph


def select_refined(out, n: int, num_classes: int) -> Detections:
    """The demo's selection (yolov_demo_online.py:81-86): both
    postprocess results of the n frames of `out` (NMS 0.5, conf 0.001, as
    the demo calls it), each frame's refined one where out["use_refined"]
    is set, else its original."""
    refined, original = yolov_eval_postprocess(out, n, num_classes)
    use = out["use_refined"].reshape(-1)
    return Detections(*(torch.where(use.reshape((-1,) + (1,) * (r.dim() - 1)), r, o)
                        for r, o in zip(refined, original)))


class OnlineStream:
    """A stream of frames through `model` with a bank of `bank_frames`
    frames (the demo's default 31) and batches of `batch` frames for
    `run_batch`. `bank` is the live bank (its tensors are overwritten by
    each step; clone one to keep it). Each step returns the frames'
    detections and `use_refined` (which of them are the refined result),
    both on the model's device (`core.predict.detection_rows` copies
    detections to the host)."""

    def __init__(self, model: YOLOVOnline, bank_frames: int = 31, batch: int = 1):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.model = model
        self.device = model.device
        self.bank = model.init_bank(bank_frames)
        self.batch = batch
        self._graphs = {}

    @torch.no_grad()
    def _run(self, x: torch.Tensor) -> Tuple[Detections, torch.Tensor]:
        if x.shape[0] == 1:
            out = self.model(x, self.bank)
            new = out["bank"]
        else:
            out, new = self.model.window(x, self.bank)
        dets = select_refined(out, x.shape[0], self.model.num_classes)
        for dst, src in zip(self.bank, new):
            dst.copy_(src)
        return dets, out["use_refined"].reshape(-1)

    def _dispatch(self, frames) -> Tuple[Detections, torch.Tensor]:
        x = torch.as_tensor(frames)
        if self.device.type != "cuda":
            return self._run(x.to(self.device))
        key = (tuple(x.shape), x.dtype)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = WindowGraph(self._run, (x,), self.device)
            return graph.first
        return graph.replay(x)

    def step(self, frame) -> Tuple[Detections, torch.Tensor]:
        """One frame (H, W, 3), fp32 or uint8, H and W multiples of 32:
        its detections (a leading axis of 1) and use_refined (1,)."""
        return self._dispatch(torch.as_tensor(frame)[None])

    def window_step(self, frames) -> Tuple[Detections, torch.Tensor]:
        """K frames (K, H, W, 3) in one step: their detections (K, ...)
        and use_refined (K,), the same as K single steps."""
        return self._dispatch(frames)

    def run_batch(self, frames: Sequence) -> List[Detections]:
        """A flushed batch of frames (H, W, 3): a full one (`batch`
        frames) as one window step, a partial one frame by frame, so the
        bank holds each frame once. One Detections a frame."""
        if len(frames) == self.batch:
            xs = (torch.stack(list(frames)) if torch.is_tensor(frames[0])
                  else np.stack([np.asarray(f) for f in frames]))
            dets, _ = self.window_step(xs)
            return [Detections(*(t[f:f + 1] for t in dets)) for f in range(len(frames))]
        return [self.step(f)[0] for f in frames]
