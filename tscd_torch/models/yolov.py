"""YOLOV family top models of the port (counterpart of
tscd_tpu/models/yolov.py: YOLOV, YOLOVPlus, YOLOVOnline,
yolov_eval_postprocess; reference yolox/models/myolox.py:8,
yolov_plus.py:8, yolov_online.py:8): YOLOPAFPN and a YOLOV head over a
window of frames, or for YOLOVOnline over one frame and a carried bank.
The forward is the eval forward; in train mode it is the training
forward, which autograd records.

As `models.tscd.TSCD` (`WindowModel`): built on `device` (the card
unless the caller passes another), fp32, BatchNorm's mode the forward's
`train` argument (the new running statistics in out["batch_stats"]),
`stop_backbone_grad` (the backbone's forward not recorded; the same
update where the backbone is frozen, as the YOLOV exps freeze it). The head's
knobs are the ones JAX's model hands to its head (yolov.py:29-43,
59-76); the others stay at JAX's head defaults (YOLOVHead's pre-NMS on,
YOLOVPlusHead's off).
"""

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import resolve_device
from ..ops.postprocess import Detections, postprocess_refined
from .tscd import WindowModel
from .tscd_head import FrameProposals
from .yolov_heads import OnlineBank, YOLOVHead, YOLOVOnlineHead, YOLOVPlusHead, init_online_bank


class YOLOV(WindowModel):
    """YOLOV (yolov.py:14): MSA aggregation over every frame of the
    window, which takes no time embedding."""

    takes_time_embedding = False

    def __init__(self, num_classes: int = 30, depth: float = 1.0, width: float = 1.0,
                 act: str = "silu", depthwise: bool = False, num_proposals: int = 30,
                 heads: int = 4, reconf: bool = False, sim_thresh: float = 0.75,
                 backbone_name: str = "MCSP", stop_backbone_grad: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        device = resolve_device(device)
        super().__init__(backbone_name, depth, width, act, depthwise, stop_backbone_grad, False)
        self.num_classes = num_classes
        self.head = YOLOVHead(num_classes, width=width, in_channels=self.backbone.out_channels,
                              act=act, depthwise=depthwise,
                              heads=heads, num_proposals=num_proposals, reconf=reconf,
                              sim_thresh=sim_thresh)
        self._place(device)

    def refined_frames(self, lframe: int, gframe: int) -> int:
        """The frames the head refines: every one."""
        return lframe + gframe

    def forward(self, x: torch.Tensor, lframe: int = 0, gframe: int = 16,
                train: bool = False) -> Dict[str, Any]:
        """x (F, H, W, 3) fp32 or uint8, H and W multiples of 32."""
        return self._window(x, train, lambda fpn_outs, stats: self.head(
            fpn_outs, lframe, gframe, stats))


class YOLOVPlus(WindowModel):
    """YOLOV++ (yolov.py:46): `agg_type` "mca" | "msa" | "localagg" and
    `decouple_reg`; takes a time embedding (and does not read it, as
    JAX's head)."""

    takes_time_embedding = True

    def __init__(self, num_classes: int = 30, depth: float = 1.0, width: float = 1.0,
                 act: str = "silu", depthwise: bool = False, num_proposals: int = 30,
                 heads: int = 4, reconf: bool = True, decouple_reg: bool = True,
                 agg_type: str = "mca", sim_thresh: float = 0.75,
                 conf_sim_thresh: float = 0.99, backbone_name: str = "MCSP",
                 stop_backbone_grad: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        device = resolve_device(device)
        super().__init__(backbone_name, depth, width, act, depthwise, stop_backbone_grad, False)
        self.num_classes = num_classes
        self.head = YOLOVPlusHead(num_classes, width=width,
                                  in_channels=self.backbone.out_channels, act=act,
                                  depthwise=depthwise,
                                  heads=heads, num_proposals=num_proposals, reconf=reconf,
                                  decouple_reg=decouple_reg, agg_type=agg_type,
                                  sim_thresh=sim_thresh, conf_sim_thresh=conf_sim_thresh)
        self._place(device)

    def refined_frames(self, lframe: int, gframe: int) -> int:
        """The frames the head refines (yolov_trainer.py:54): the local
        ones, or every one with lframe 0."""
        return lframe if lframe > 0 else lframe + gframe

    def forward(self, x: torch.Tensor, lframe: int, gframe: int,
                time_embedding: Optional[torch.Tensor] = None,
                train: bool = False) -> Dict[str, Any]:
        return self._window(x, train, lambda fpn_outs, stats: self.head(
            fpn_outs, lframe, gframe, time_embedding, stats))


class YOLOVOnline(WindowModel):
    """Streaming YOLOV (yolov.py:84-137) with the device-resident
    `OnlineBank`, evaluated (no online trainer exists in either package):
    `forward(x, bank)` runs one frame (x (1, H, W, 3)) and returns the
    head's dict with the new bank in out["bank"]; `window(xs, bank)` runs
    K frames, the backbone batched over them and the head once a frame
    with the bank threaded through, the same as K single calls."""

    def __init__(self, num_classes: int = 30, depth: float = 1.0, width: float = 1.0,
                 act: str = "silu", depthwise: bool = False, num_proposals: int = 30,
                 heads: int = 4, sim_thresh: float = 0.75, backbone_name: str = "MCSP",
                 device: Optional[Union[str, torch.device]] = None):
        device = resolve_device(device)
        super().__init__(backbone_name, depth, width, act, depthwise, False, False)
        self.num_classes = num_classes
        self.head = YOLOVOnlineHead(num_classes, width=width,
                                    in_channels=self.backbone.out_channels, act=act,
                                    depthwise=depthwise,
                                    heads=heads, num_proposals=num_proposals,
                                    sim_thresh=sim_thresh)
        self._place(device)

    def init_bank(self, bank_frames: int = 31) -> OnlineBank:
        """An empty bank of `bank_frames` frames' proposals on the model's
        device (the demo's init_online_bank(bank_frames x P, hidden))."""
        return init_online_bank(bank_frames * self.head.num_proposals, self.head.hidden,
                                device=self.device)

    def forward(self, x: torch.Tensor, bank: OnlineBank) -> Dict[str, Any]:
        return self._window(x, False, lambda fpn_outs, stats: self.head(fpn_outs, bank, stats))

    def window(self, xs: torch.Tensor, bank: OnlineBank) -> Tuple[Dict[str, Any], OnlineBank]:
        """K frames xs (K, H, W, 3): (the head's outputs stacked with a
        leading K, `use_refined` (K,), one `hw`; the bank after the K
        frames)."""
        def frames(fpn_outs, stats):
            nonlocal bank
            outs = []
            for f in range(xs.shape[0]):
                o = self.head([lvl[f:f + 1] for lvl in fpn_outs], bank, stats)
                bank = o.pop("bank")
                outs.append(o)
            stacked = {k: torch.cat([o[k] for o in outs], 0)
                       for k in ("raw_outputs", "decoded", "refined_cls_logits")}
            stacked["proposals"] = FrameProposals(*(torch.cat(t, 0) for t in zip(
                *(o["proposals"] for o in outs))))
            stacked["use_refined"] = torch.stack([o["use_refined"] for o in outs])
            stacked["hw"] = outs[0]["hw"]
            return stacked
        return self._window(xs, False, frames), bank


def yolov_eval_postprocess(head_out: Dict[str, Any], num_frames: int, num_classes: int,
                           nms_thresh: float = 0.5, conf_thre: float = 0.001,
                           out_k: int = 100, original: bool = True
                           ) -> Tuple[Detections, Optional[Detections]]:
    """The eval postprocess (yolov.py:140-164): the first `num_frames`
    frames' proposals with the refined class scores (and the refined obj
    where the head has it, else the proposals'), every (proposal, class)
    pair through class-aware NMS (`postprocess_refined`, the hand NMS
    kernel at K = P x C); `original` the same on the still detector's
    scores. JAX's predict function reads only `refined`; with
    `original=False` the second is not computed (None)."""
    props = head_out["proposals"]
    n = num_frames
    cls_ref = torch.sigmoid(head_out["refined_cls_logits"].to(torch.float32))
    obj = (torch.sigmoid(head_out["refined_obj_logits"].to(torch.float32))
           if "refined_obj_logits" in head_out else props.obj[:n])
    refined = postprocess_refined(props.boxes[:n], obj, cls_ref[:n], props.valid[:n],
                                  conf_thre, nms_thresh, out_k)
    if not original:
        return refined, None
    return refined, postprocess_refined(props.boxes[:n], props.obj[:n], props.cls_scores[:n],
                                        props.valid[:n], conf_thre, nms_thresh, out_k)
