"""Streaming eval step (counterpart of TSCDTrainer.make_predict_fn,
tscd_tpu/core/tscd_trainer.py:418-472).

JAX runs a window as one jitted program. Its counterpart here, on a
card, is one CUDA graph a window: captured at the first dispatch of each
frame shape and dtype, then replayed with new inputs, so the host
enqueues a window with a few copies and one replay instead of launching
each of its kernels. CPU tensors take the eager path.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.matching import MatcherState, init_matcher_state
from ..models.tscd import TSCD, tscd_eval_postprocess
from ..ops.postprocess import Detections

Window = Tuple[Detections, MatcherState]


def _clone(out):
    """A copy of each tensor of `out` (a tensor, None or a (named) tuple of
    them)."""
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return out.clone()
    items = [_clone(t) for t in out]
    return type(out)(*items) if hasattr(out, "_fields") else tuple(items)


class WindowGraph:
    """One captured window: static buffers for its input tensors (the
    frames, the time embedding and, for TSCD, the matcher state's
    tensors), the graph and its outputs.

    The first window runs eagerly on the static buffers (it loads the
    kernel library, picks the cuDNN and cuBLAS plans, uploads the decode
    grids) and its result is that dispatch's; the capture follows. A fresh
    and a carried state go through the same graph: the state's has_state
    gate chooses the sequence-start branch on the device, as in JAX's one
    program. A failed capture raises. A replay runs no Python, so the
    kernel wrappers' launch counts do not move with it."""

    def __init__(self, run: Callable, inputs: Tuple[torch.Tensor, ...],
                 device: torch.device):
        self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                            for t in inputs)
        self._load(inputs)
        self.first = run(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's worker thread pins host memory while
        # this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = run(*self.inputs)

    def _load(self, inputs: Tuple[torch.Tensor, ...]):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)

    def replay(self, *inputs: torch.Tensor):
        """The window on new inputs. Returns copies of the outputs: the
        pipelined evaluator reads window i after dispatching i + 1."""
        self._load(inputs)
        self.graph.replay()
        return _clone(self.out)


def detection_rows(refined: Detections) -> List[np.ndarray]:
    """Detections copied to the host as per-frame [x1, y1, x2, y2, obj,
    score, cls] rows, one array a frame."""
    r = Detections(*(t.cpu().numpy() for t in refined))
    return [np.concatenate([r.boxes[f], r.obj[f][:, None], r.score[f][:, None],
                            r.cls_id[f][:, None].astype(np.float32)], -1)[r.mask[f]]
            for f in range(r.mask.shape[0])]


def window_predict_fn(run: Callable, inputs: Callable, device: torch.device):
    """The streaming evaluator's step around one window's program:
    inputs(imgs, te, resume, state) gives the window's host-side tensors
    (the frames and the time embedding first), run(*tensors) on the
    device gives (refined Detections, new state). Returns
    predict(imgs, te, resume, state) -> (per-frame detection rows, new
    state).

    `predict.dispatch` runs one window on `device` and returns run's
    result without reading it back or waiting on the card: the frames
    (numpy or tensors, uint8 as the loader ships them) upload with
    non_blocking copies, which from pinned memory do not wait. On a card
    the window is a replayed CUDA graph (captured at the first dispatch
    of each frame shape and dtype). `predict.dispatch_eager` runs the same
    window launch by launch: the reference that a replay is held equal
    to, and the path for code that must watch the window's Python calls.
    `predict.materialize` copies the Detections to the host as per-frame
    [x1, y1, x2, y2, obj, score, cls] rows, one list a frame of them."""
    graphs: Dict[tuple, WindowGraph] = {}

    def dispatch_eager(imgs, te, resume: bool, state):
        x, t, *rest = inputs(imgs, te, resume, state)
        return run(x.to(device, non_blocking=True), t.to(device, non_blocking=True), *rest)

    def dispatch(imgs, te, resume: bool, state):
        if device.type != "cuda":
            return dispatch_eager(imgs, te, resume, state)
        tensors = inputs(imgs, te, resume, state)
        x, t = tensors[:2]
        key = (tuple(x.shape), x.dtype, tuple(t.shape))
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = WindowGraph(run, tensors, device)
            return graph.first
        return graph.replay(*tensors)

    def predict(imgs, te, resume: bool, state):
        refined, new_state = dispatch(imgs, te, resume, state)
        return detection_rows(refined), new_state

    predict.dispatch = dispatch
    predict.dispatch_eager = dispatch_eager
    predict.materialize = detection_rows
    return predict


def make_predict_fn(model: TSCD, lframe: int, gframe: int,
                    nms_thresh: float = 0.5, conf_thre: float = 0.001):
    """Returns predict(imgs, te, resume, state) -> (detection rows of each
    local frame, new MatcherState) for the streaming evaluator, with
    `dispatch`, `dispatch_eager` and `materialize` (`window_predict_fn`).
    `resume` chooses the carried state, else a fresh one (the
    sequence-start reset)."""
    head = model.head
    device = model.device
    # a fresh bank in the model's compute dtype (a bf16 model carries its
    # bank in bf16), gated by has_state=False, as JAX reads model.dtype
    fresh = init_matcher_state(head.num_proposals, head.hidden,
                               4 * head.hidden, dtype=model.dtype,
                               device=device)
    C = model.num_classes

    @torch.no_grad()
    def run(x: torch.Tensor, t: torch.Tensor, *st: torch.Tensor) -> Window:
        out = model(x, t, lframe, gframe, matcher_state=MatcherState(*st))
        refined, _ = tscd_eval_postprocess(out, lframe, C,
                                           nms_thresh=nms_thresh,
                                           conf_thre=conf_thre)
        return refined, out["matcher_state"]

    def inputs(imgs, te, resume, state):
        st = state if (resume and state is not None) else fresh
        return (torch.as_tensor(imgs), torch.as_tensor(te, dtype=torch.float32), *st)

    return window_predict_fn(run, inputs, device)
