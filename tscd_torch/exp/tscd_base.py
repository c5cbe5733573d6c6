"""Video (TSCD) experiment base (counterpart of
tscd_tpu/exp/tscd_base.py; reference exps/TSCD_VID/tscd_base.py), with
the attributes the eval path reads. The defaults are TSCD-Large on
ImageNet VID (exps/TSCD_VID/vid_tscd_large.py). The repo's `exps/*.py`
files build on the JAX package's base; port exp files subclass this one.
"""

from typing import Optional, Union

import numpy as np
import torch

from ..models.tscd import TSCD
from .base_exp import BaseExp


class TSCDExp(BaseExp):
    def __init__(self):
        # model (vid_tscd_large.py:13-45)
        self.num_classes = 30
        self.depth = 1.0
        self.width = 1.0
        self.act = "silu"
        self.depthwise = False
        self.test_size = (576, 576)
        self.backbone_name = "MCSP"
        # proposals, aggregation, matcher
        self.minimal_limit = 50
        self.maximal_limit = 0          # 0: the slot count P is minimal_limit
        self.heads = 4
        self.decoder_layer_num = 1
        self.sim_thresh = 0.75
        self.conf_sim_thresh = 0.99
        # eval windows and postprocess (tscd_base.py:38-126, :60-61)
        self.lframe_val = 1
        self.gframe_val = 31
        self.mode = "random"
        self.local_stride = 1
        self.traj_linking = False
        self.tnum = -1
        self.nmsthre = 0.5
        self.test_conf = 0.001
        # eval windows upload as raw uint8 (bit-exact; 4x lighter)
        self.eval_uint8_transport = True
        self.seed = 2024
        # data
        self.data_dir = "./datasets/ILSVRC2015"
        self.val_seq_path = "./yolox/data/datasets/val_seq.npy"
        self.anno_cache = ""
        self.dataset_name = "vid"       # vid (ovis is not ported yet)

    @property
    def num_proposals(self) -> int:
        return self.maximal_limit or self.minimal_limit

    def get_model(self, device: Optional[Union[str, torch.device]] = None
                  ) -> TSCD:
        """The eval model on `device`, the card unless the caller asks for
        another."""
        return TSCD(num_classes=self.num_classes, depth=self.depth,
                    width=self.width, act=self.act, depthwise=self.depthwise,
                    num_proposals=self.num_proposals,
                    minimal_limit=self.minimal_limit, heads=self.heads,
                    decoder_layer_num=self.decoder_layer_num,
                    sim_thresh=self.sim_thresh,
                    conf_sim_thresh=self.conf_sim_thresh,
                    test_conf=self.test_conf,
                    backbone_name=self.backbone_name, device=device)

    def get_eval_loader(self, lframe: Optional[int] = None,
                        gframe: Optional[int] = None,
                        pin_memory: bool = False):
        """The val windows (tscd_base.py:223). `pin_memory` for a CUDA
        predict device: windows arrive in pinned memory."""
        from ..data.vid import VIDDataset, WindowLoader
        if self.dataset_name != "vid":
            raise NotImplementedError(
                f"dataset {self.dataset_name!r}: the port reads ImageNet VID "
                "only (ROADMAP queue 1 item 7)")
        ds = VIDDataset(
            file_path=self.val_seq_path, img_size=self.test_size,
            lframe=lframe or self.lframe_val, gframe=gframe or self.gframe_val,
            val=True, mode=self.mode, dataset_pth=self.data_dir,
            tnum=self.tnum, traj_linking=self.traj_linking,
            local_stride=self.local_stride, cache_file=self.anno_cache,
            formal=True)
        dtype = np.uint8 if self.eval_uint8_transport else np.float32
        return WindowLoader(ds, img_dtype=dtype, pin_memory=pin_memory)

    def get_evaluator(self, val_loader=None):
        """tscd_base.py:238."""
        from ..eval.vid_evaluator import OVISEvaluator, VIDEvaluator
        cls = OVISEvaluator if self.dataset_name == "ovis" else VIDEvaluator
        return cls(val_loader or self.get_eval_loader(),
                   img_size=self.test_size, confthre=self.test_conf,
                   nmsthre=self.nmsthre, num_classes=self.num_classes,
                   lframe=self.lframe_val, gframe=self.gframe_val,
                   traj_linking=self.traj_linking)
