"""Streaming eval step (counterpart of TSCDTrainer.make_predict_fn,
tscd_tpu/core/tscd_trainer.py:418-472).

JAX runs a window as one jitted program. Its counterpart here, on a
card, is one CUDA graph a window: captured at the first dispatch of each
frame shape and dtype, then replayed with new inputs, so the host
enqueues a window with a few copies and one replay instead of launching
each of its kernels. CPU tensors take the eager path.
"""

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.matching import MatcherState, init_matcher_state
from ..models.tscd import TSCD, tscd_eval_postprocess
from ..ops.postprocess import Detections

Window = Tuple[Detections, MatcherState]


def _clone(out: Window) -> Window:
    refined, state = out
    return (Detections(*(t.clone() for t in refined)),
            MatcherState(*(t.clone() for t in state)))


class _WindowGraph:
    """One captured window: static buffers for the frames, the time
    embedding and the matcher state, the graph and its outputs.

    The first window runs eagerly on the static buffers (it loads the
    kernel library, picks the cuDNN and cuBLAS plans, uploads the decode
    grids) and its result is that dispatch's; the capture follows. A fresh
    and a carried state go through the same graph: the state's has_state
    gate chooses the sequence-start branch on the device, as in JAX's one
    program. A failed capture raises. A replay runs no Python, so the
    kernel wrappers' launch counts do not move with it."""

    def __init__(self, run: Callable[..., Window], x: torch.Tensor,
                 t: torch.Tensor, st: MatcherState, device: torch.device):
        self.x = torch.empty(x.shape, dtype=x.dtype, device=device)
        self.t = torch.empty(t.shape, dtype=t.dtype, device=device)
        self.state = MatcherState(*(torch.empty_like(s) for s in st))
        self._load(x, t, st)
        self.first = run(self.x, self.t, self.state)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's worker thread pins host memory while
        # this thread captures
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = run(self.x, self.t, self.state)

    def _load(self, x: torch.Tensor, t: torch.Tensor, st: MatcherState):
        self.x.copy_(x, non_blocking=True)
        self.t.copy_(t, non_blocking=True)
        for dst, src in zip(self.state, st):
            dst.copy_(src, non_blocking=True)

    def replay(self, x: torch.Tensor, t: torch.Tensor,
               st: MatcherState) -> Window:
        """The window on new inputs. Returns copies of the outputs: the
        pipelined evaluator reads window i after dispatching i + 1."""
        self._load(x, t, st)
        self.graph.replay()
        return _clone(self.out)


def make_predict_fn(model: TSCD, lframe: int, gframe: int,
                    nms_thresh: float = 0.5, conf_thre: float = 0.001):
    """Returns predict(imgs, te, resume, state) -> (per-frame detection
    rows, new state) for the streaming evaluator.

    `predict.dispatch` runs one window on the model's device and returns
    the refined Detections and the new MatcherState without reading them
    back or waiting on the card: the frames (numpy or tensors, uint8 as
    the loader ships them) upload with non_blocking copies, which from
    pinned memory do not wait. On a card the window is a replayed CUDA
    graph (captured at the first dispatch of each frame shape and dtype).
    `predict.dispatch_eager` runs the same window launch by launch: the
    reference that a replay is held equal to, and the path for code that
    must watch the window's Python calls.
    `predict.materialize` copies the Detections to the host as per-frame
    [x1, y1, x2, y2, obj, score, cls] rows. `resume` chooses the carried
    state, else a fresh one (the sequence-start reset)."""
    head = model.head
    device = model.device
    # a fresh bank in the model's compute dtype (a bf16 model carries its
    # bank in bf16), gated by has_state=False, as JAX reads model.dtype
    fresh = init_matcher_state(head.num_proposals, head.hidden,
                               4 * head.hidden, dtype=model.dtype,
                               device=device)
    C = model.num_classes
    graphs: Dict[tuple, _WindowGraph] = {}

    @torch.no_grad()
    def run(x: torch.Tensor, t: torch.Tensor, st: MatcherState) -> Window:
        out = model(x, t, lframe, gframe, matcher_state=st)
        refined, _ = tscd_eval_postprocess(out, lframe, C,
                                           nms_thresh=nms_thresh,
                                           conf_thre=conf_thre)
        return refined, out["matcher_state"]

    def inputs(imgs, te, resume, state):
        st = state if (resume and state is not None) else fresh
        return (torch.as_tensor(imgs), torch.as_tensor(te, dtype=torch.float32),
                st)

    def dispatch_eager(imgs, te, resume: bool, state: Optional[MatcherState]
                       ) -> Window:
        x, t, st = inputs(imgs, te, resume, state)
        return run(x.to(device, non_blocking=True),
                   t.to(device, non_blocking=True), st)

    def dispatch(imgs, te, resume: bool, state: Optional[MatcherState]
                 ) -> Window:
        if device.type != "cuda":
            return dispatch_eager(imgs, te, resume, state)
        x, t, st = inputs(imgs, te, resume, state)
        key = (tuple(x.shape), x.dtype, tuple(t.shape))
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = _WindowGraph(run, x, t, st, device)
            return graph.first
        return graph.replay(x, t, st)

    def materialize(refined: Detections) -> List[np.ndarray]:
        r = Detections(*(t.cpu().numpy() for t in refined))
        dets = []
        for f in range(lframe):
            rows = np.concatenate([
                r.boxes[f], r.obj[f][:, None], r.score[f][:, None],
                r.cls_id[f][:, None].astype(np.float32)], -1)
            dets.append(rows[r.mask[f]])
        return dets

    def predict(imgs, te, resume: bool, state: Optional[MatcherState]):
        refined, new_state = dispatch(imgs, te, resume, state)
        return materialize(refined), new_state

    predict.dispatch = dispatch
    predict.dispatch_eager = dispatch_eager
    predict.materialize = materialize
    return predict
