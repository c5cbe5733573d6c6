"""The port's copy of tscd_tpu/postprocess/__init__.py (numpy; no JAX)."""

from .linking import (get_linking_mat, get_tubelets,
                      online_previous_selection, post_linking)
from .motion_eval import MOTION_RANGES, vid_eval_motion
from .repp import REPP, get_pair_features, repp_to_coco, rows_to_repp

__all__ = ["REPP", "get_pair_features", "repp_to_coco", "rows_to_repp",
           "get_linking_mat", "get_tubelets", "post_linking",
           "online_previous_selection", "vid_eval_motion",
           "MOTION_RANGES"]
