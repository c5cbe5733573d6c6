"""Streaming eval step (counterpart of TSCDTrainer.make_predict_fn,
tscd_tpu/core/tscd_trainer.py:418-472)."""

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.matching import MatcherState, init_matcher_state
from ..models.tscd import TSCD, tscd_eval_postprocess
from ..ops.postprocess import Detections


def make_predict_fn(model: TSCD, lframe: int, gframe: int,
                    nms_thresh: float = 0.5, conf_thre: float = 0.001):
    """Returns predict(imgs, te, resume, state) -> (per-frame detection
    rows, new state) for the streaming evaluator.

    `predict.dispatch` runs one window on the model's device and returns
    the refined Detections and the new MatcherState without reading them
    back; `predict.materialize` copies the Detections to the host as
    per-frame [x1, y1, x2, y2, obj, score, cls] rows. `resume` chooses
    the carried state, else a fresh one (the sequence-start reset)."""
    head = model.head
    device = model.device
    # a fresh bank in the model dtype, gated by has_state=False
    fresh = init_matcher_state(head.num_proposals, head.hidden,
                               4 * head.hidden,
                               dtype=next(model.parameters()).dtype,
                               device=device)
    C = model.num_classes

    def dispatch(imgs, te, resume: bool, state: Optional[MatcherState]
                 ) -> Tuple[Detections, MatcherState]:
        st = state if (resume and state is not None) else fresh
        x = torch.as_tensor(imgs).to(device)
        t = torch.as_tensor(te, dtype=torch.float32).to(device)
        out = model(x, t, lframe, gframe, matcher_state=st)
        refined, _ = tscd_eval_postprocess(out, lframe, C,
                                           nms_thresh=nms_thresh,
                                           conf_thre=conf_thre)
        return refined, out["matcher_state"]

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
    predict.materialize = materialize
    return predict
