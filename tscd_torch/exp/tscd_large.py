"""TSCD-Large on ImageNet VID, eval settings: the values of
exps/TSCD_VID/vid_tscd_large.py and its base tscd_tpu/exp/tscd_base.py
that the eval forward reads, as a plain config."""

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..models.tscd import TSCD


@dataclasses.dataclass
class Exp:
    num_classes: int = 30
    depth: float = 1.0
    width: float = 1.0
    act: str = "silu"
    depthwise: bool = False
    lframe_val: int = 1
    gframe_val: int = 31
    test_size: Tuple[int, int] = (576, 576)
    minimal_limit: int = 50
    maximal_limit: int = 0          # 0: the slot count P is minimal_limit
    heads: int = 4
    decoder_layer_num: int = 1
    sim_thresh: float = 0.75
    conf_sim_thresh: float = 0.99
    nmsthre: float = 0.5
    test_conf: float = 0.001
    backbone_name: str = "MCSP"
    seed: int = 2024

    @property
    def num_proposals(self) -> int:
        return self.maximal_limit or self.minimal_limit

    def get_model(self, device: Optional[Union[str, torch.device]] = None
                  ) -> TSCD:
        return TSCD(num_classes=self.num_classes, depth=self.depth,
                    width=self.width, act=self.act, depthwise=self.depthwise,
                    num_proposals=self.num_proposals,
                    minimal_limit=self.minimal_limit, heads=self.heads,
                    decoder_layer_num=self.decoder_layer_num,
                    sim_thresh=self.sim_thresh,
                    conf_sim_thresh=self.conf_sim_thresh,
                    test_conf=self.test_conf,
                    backbone_name=self.backbone_name, device=device)


def selftest_exp() -> Exp:
    """The small configuration of YOLOX_outputs/validate_ref/
    selftest_exp.py: depth 0.33, width 0.125, P=6, 1+3 frames, 128 px."""
    return Exp(depth=0.33, width=0.125, minimal_limit=6, maximal_limit=6,
               gframe_val=3, test_size=(128, 128), seed=0)
