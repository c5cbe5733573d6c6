"""Video (TSCD) experiment base (counterpart of
tscd_tpu/exp/tscd_base.py and the training knobs of yolox_base.py;
reference exps/TSCD_VID/tscd_base.py), with the attributes the eval and
stage-2 training paths read. The defaults are TSCD-Large on ImageNet VID
(exps/TSCD_VID/vid_tscd_large.py). The repo's `exps/*.py` files build on
the JAX package's base; port exp files subclass this one.
"""

from typing import Optional, Sequence, Union

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
        self.train_seq_path = "./yolox/data/datasets/train_seq.npy"
        self.anno_cache = ""
        self.dataset_name = "vid"       # vid (ovis is not ported yet)
        # stage-2 training (tscd_base.py:97-120, yolox_base.py:56-80)
        self.lframe = 4
        self.gframe = 12
        self.input_size = (576, 576)
        self.max_epoch = 7
        self.no_aug_epochs = 2
        self.warmup_epochs = 1
        self.warmup_lr = 0.0
        self.basic_lr_per_img = 0.002 / 64.0
        self.batch_size = 16            # = lframe + gframe (one window)
        self.min_lr_ratio = 0.05
        self.scheduler = "yoloxwarmcos"
        self.momentum = 0.9
        self.weight_decay = 5e-4
        self.stem_lr_ratio = 0.1
        self.ema_decay = 0.9998
        self.ota_mode = True
        self.fix_bn = True              # frozen backbone: BN on running stats
        self.stop_backbone_grad = True
        self.hsv_prob = 1.0
        self.flip_prob = 0.5
        self.print_interval = 10
        self.eval_interval = 1
        self.ckpt_interval = 1
        self.output_dir = "./YOLOX_outputs"
        self.exp_name = "tscd_large"
        # knobs of the JAX trainer the port does not run yet; each raises
        # unless at this default (`check_train_knobs`)
        self.enable_multiscale = False
        self.window_batch = 0
        self.grad_accum = 1
        self.mesh_data = 1
        self.mesh_model = 1
        self.fsdp = False
        self.int8_frozen_backbone = False
        self.int8_qat = False

    @property
    def num_proposals(self) -> int:
        return self.maximal_limit or self.minimal_limit

    def get_model(self, device: Optional[Union[str, torch.device]] = None
                  ) -> TSCD:
        """The model on `device`, the card unless the caller asks for
        another. Its training forward is stage 2's (`fix_bn`,
        `stop_backbone_grad`)."""
        return TSCD(num_classes=self.num_classes, depth=self.depth,
                    width=self.width, act=self.act, depthwise=self.depthwise,
                    num_proposals=self.num_proposals,
                    minimal_limit=self.minimal_limit, heads=self.heads,
                    decoder_layer_num=self.decoder_layer_num,
                    sim_thresh=self.sim_thresh,
                    conf_sim_thresh=self.conf_sim_thresh,
                    test_conf=self.test_conf,
                    backbone_name=self.backbone_name, device=device)

    # -- stage-2 training ------------------------------------------------
    def freeze_prefixes(self) -> Sequence[str]:
        """Flax-path prefixes frozen in stage 2 (vid_tscd_large.py:111-143)."""
        return ("backbone",)

    def stem_lr_prefixes(self) -> Sequence[str]:
        """Flax-path prefixes of the stem_lr_ratio groups
        (vid_tscd_large.py:157-190)."""
        return ("head/stem_", "head/cls_conv_", "head/reg_conv_",
                "head/cls_pred_", "head/reg_pred_", "head/obj_pred_")

    def check_train_knobs(self):
        """Raises for a training knob the port does not run yet, and where
        `stop_backbone_grad` has no frozen backbone (tscd_base.py:143-152)."""
        if not self.fix_bn:
            raise NotImplementedError(
                "fix_bn=False (train-mode BatchNorm) is not ported yet "
                "(ROADMAP queue 1 item 9, what it leaves, 1)")
        if not self.stop_backbone_grad:
            raise NotImplementedError(
                "stop_backbone_grad=False needs the Focus stem's backward, "
                "which is not ported (ROADMAP queue 2 item 2)")
        if not any(p.startswith("backbone") for p in self.freeze_prefixes()):
            raise ValueError("stop_backbone_grad=True but freeze_prefixes() "
                             "does not freeze the backbone")
        leftovers = {"enable_multiscale": ("multiscale", 4),
                     "int8_frozen_backbone": ("int8_frozen_backbone", 5),
                     "int8_qat": ("int8_qat", 5), "fsdp": ("a mesh", 3)}
        for knob, (what, item) in leftovers.items():
            if getattr(self, knob):
                raise NotImplementedError(
                    f"{knob}: {what} is not ported yet (ROADMAP queue 1 item 9, "
                    f"what it leaves, {item})")
        for knob in ("window_batch", "grad_accum", "mesh_data", "mesh_model"):
            if int(getattr(self, knob) or 1) != 1:
                raise NotImplementedError(
                    f"{knob} = {getattr(self, knob)}: the port trains one window "
                    "a step on one card (ROADMAP queue 1 item 9, what it leaves, 3)")

    def get_lr_schedule(self, iters_per_epoch: int):
        from ..train.lr import cos_lr, multistep_lr, warm_cos_lr, yolox_warm_cos_lr
        lr = self.basic_lr_per_img * self.batch_size
        total = iters_per_epoch * self.max_epoch
        warm = iters_per_epoch * self.warmup_epochs
        if self.scheduler == "yoloxwarmcos":
            return yolox_warm_cos_lr(lr, self.min_lr_ratio, total, warm,
                                     self.warmup_lr,
                                     iters_per_epoch * self.no_aug_epochs)
        if self.scheduler == "warmcos":
            return warm_cos_lr(lr, total, warm)
        if self.scheduler == "cos":
            return cos_lr(lr, total)
        if self.scheduler == "multistep":
            return multistep_lr(lr, [total * 2 // 3, total * 5 // 6])
        raise ValueError(f"unknown scheduler {self.scheduler}")

    def get_optimizer(self, model: TSCD, iters_per_epoch: int):
        from ..train.optim import GroupedSGD
        return GroupedSGD(model.named_parameters(),
                          self.get_lr_schedule(iters_per_epoch),
                          momentum=self.momentum, weight_decay=self.weight_decay,
                          freeze_prefixes=self.freeze_prefixes(),
                          stem_lr_prefixes=self.stem_lr_prefixes(),
                          stem_lr_ratio=self.stem_lr_ratio)

    def get_train_dataset(self):
        """The training windows (tscd_base.py:_vid_dataset, training)."""
        from ..data.vid import VIDDataset
        if self.dataset_name != "vid":
            raise NotImplementedError(
                f"dataset {self.dataset_name!r}: the port reads ImageNet VID only")
        return VIDDataset(
            file_path=self.train_seq_path, img_size=self.input_size,
            lframe=self.lframe, gframe=self.gframe, val=False, mode=self.mode,
            dataset_pth=self.data_dir, tnum=self.tnum,
            local_stride=self.local_stride, cache_file=self.anno_cache,
            training=True)

    def get_data_loader(self, no_aug: bool = False, pin_memory: bool = False,
                        rng: Optional[np.random.Generator] = None,
                        dataset=None):
        """Shuffled training windows of `dataset` (`get_train_dataset()`
        unless given; tscd_base.py get_data_loader): up to 120 cxcywh
        labels a frame, the window's own frame index as time, and unless
        `no_aug` the window's flip (its HSV jitter raises for hsv_prob >
        0). Uint8 frames, pinned for a CUDA device."""
        from ..data.vid import WindowLoader
        ds = dataset if dataset is not None else self.get_train_dataset()
        return WindowLoader(ds, pin_memory=pin_memory, shuffle=True,
                            train_time_index=True, cxcywh=True,
                            augment=not no_aug, hsv_prob=self.hsv_prob,
                            flip_prob=self.flip_prob, rng=rng)

    def get_trainer(self, args=None, device=None):
        from ..core.tscd_trainer import TSCDTrainer
        return TSCDTrainer(self, args, device=device)

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
