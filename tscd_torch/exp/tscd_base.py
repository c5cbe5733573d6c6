"""Video (TSCD) experiment base (counterpart of
tscd_tpu/exp/tscd_base.py and the training knobs of yolox_base.py;
reference exps/TSCD_VID/tscd_base.py), with the attributes the eval and
stage-2 training paths read. The defaults are TSCD-Large on ImageNet VID
(exps/TSCD_VID/vid_tscd_large.py). The repo's `exps/*.py` files build on
the JAX package's base; port exp files subclass this one.
"""

import random
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.tscd import TSCD
from .base_exp import BaseExp


# Model knobs of the JAX exp that `get_model` raises for: {knob: (the
# values the port runs, the first JAX's default; why not the others)}.
# JAX's exp never hands these six to its TSCD (tscd_base.py:149-165),
# which leaves them at its head's defaults: another value in an exp has no
# JAX counterpart. The head takes them (models/tscd_head.py: TSCDHead).
_NOT_PASSED = ("JAX's exp does not pass it to its TSCD, so no other value has a JAX "
               "counterpart; TSCDHead takes it")
MODEL_KNOBS = {
    "ave": ((True,), _NOT_PASSED), "use_mask": ((False,), _NOT_PASSED),
    "vid_cls": ((True,), _NOT_PASSED), "vid_reg": ((True,), _NOT_PASSED),
    "pre_nms": ((0.75,), _NOT_PASSED), "defualt_pre": ((750,), _NOT_PASSED),
}


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
        self.dataset_name = "vid"       # vid | ovis (tscd_base.py:129-132)
        self.ovis_train_json = ""
        self.ovis_val_json = ""
        self.ovis_name = ""
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
        # multiscale (yolox_base.py random_resize, the video rule of
        # tscd_base.py:24-25): +-multiscale_range x 64 px, a new size every
        # 10 iterations
        self.enable_multiscale = False
        self.multiscale_range = 3
        self.multiscale_step = 64
        self.print_interval = 10
        self.eval_interval = 1
        self.ckpt_interval = 1
        self.output_dir = "./YOLOX_outputs"
        self.exp_name = "tscd_large"
        # model knobs of the JAX exp (tscd_base.py:53-70,99-101) at its
        # defaults: those JAX's TSCD takes, then those `get_model` raises
        # for at another value (MODEL_KNOBS)
        self.agg_type = "mca"           # "mca" | "mca_aware" | "localagg"
        self.use_pre_nms = False
        self.cat_ota_fg = False
        self.decouple_reg = True
        self.reconf = True
        self.sparse_vid_towers = False
        for knob, (values, _) in MODEL_KNOBS.items():
            setattr(self, knob, values[0])
        # the JAX trainer's window batching and memory knobs
        # (tscd_trainer.py:65-74, :170-252): window_batch windows a step (0:
        # one per card), their gradients accumulated over grad_accum chunks;
        # remat_backbone recomputes the backbone in the backward
        self.window_batch = 0
        self.grad_accum = 1
        self.remat_backbone = False
        # knobs of the JAX trainer the port does not run yet; each raises
        # unless at this default (`check_train_knobs`)
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
        another, with the exp's `stop_backbone_grad` and `remat_backbone`.
        Raises for a model knob at a value the port does not run
        (MODEL_KNOBS), and,
        as JAX's (tscd_base.py:143-152), where `stop_backbone_grad` would
        sever the gradients of a backbone that is not frozen."""
        for knob, (values, why) in MODEL_KNOBS.items():
            if getattr(self, knob) not in values:
                raise NotImplementedError(
                    f"{knob} = {getattr(self, knob)!r}: the port's TSCD runs "
                    f"{' or '.join(map(repr, values))}: {why}")
        if self.stop_backbone_grad and not any(
                p.startswith("backbone") for p in self.freeze_prefixes()):
            raise ValueError("stop_backbone_grad=True but freeze_prefixes() does not "
                             "freeze the backbone; set stop_backbone_grad=False "
                             "for a full fine-tune")
        return TSCD(num_classes=self.num_classes, depth=self.depth,
                    width=self.width, act=self.act, depthwise=self.depthwise,
                    num_proposals=self.num_proposals,
                    minimal_limit=self.minimal_limit, heads=self.heads,
                    agg_type=self.agg_type, cat_ota_fg=self.cat_ota_fg,
                    reconf=self.reconf, decouple_reg=self.decouple_reg,
                    use_pre_nms=self.use_pre_nms,
                    sparse_vid_towers=self.sparse_vid_towers,
                    decoder_layer_num=self.decoder_layer_num,
                    sim_thresh=self.sim_thresh,
                    conf_sim_thresh=self.conf_sim_thresh,
                    test_conf=self.test_conf,
                    backbone_name=self.backbone_name,
                    stop_backbone_grad=self.stop_backbone_grad,
                    remat_backbone=self.remat_backbone, device=device)

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
        """Raises for a training knob the port does not run yet (int8,
        meshes), and where `grad_accum` does not divide the window batch
        (tscd_trainer.py:178-181)."""
        leftovers = {"int8_frozen_backbone": ("int8_frozen_backbone", "2.8"),
                     "int8_qat": ("int8_qat", "2.8"), "fsdp": ("a mesh", "8")}
        for knob, (what, item) in leftovers.items():
            if getattr(self, knob):
                raise NotImplementedError(
                    f"{knob}: {what} is not ported yet (ROADMAP queue 1 item {item})")
        for knob in ("mesh_data", "mesh_model"):
            if int(getattr(self, knob) or 1) != 1:
                raise NotImplementedError(
                    f"{knob} = {getattr(self, knob)}: the port trains on one card "
                    "(ROADMAP queue 1 item 8)")
        accum, batch = int(self.grad_accum or 1), self.windows_per_step
        if accum > 1 and batch % accum:
            raise ValueError(f"grad_accum({accum}) needs window_batch a multiple of it "
                             f"(window_batch={batch})")

    @property
    def windows_per_step(self) -> int:
        """Windows an optimizer step takes: `window_batch`, 0 meaning one
        (one card, tscd_trainer.py:69-71)."""
        return int(self.window_batch or 0) or 1

    def random_input_size(self, rng: random.Random) -> Tuple[int, int]:
        """A multiscale size (yolox_base.py:171-182 with the video rule):
        step x k for k drawn from `rng` within +-multiscale_range of
        input_size / step, the width scaled by the input's aspect."""
        step = self.multiscale_step
        base = self.input_size[0] // step
        k = rng.randint(base - self.multiscale_range, base + self.multiscale_range)
        size_factor = self.input_size[1] / self.input_size[0]
        return (step * k, step * int(k * size_factor))

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

    def get_optimizer(self, model: TSCD, iters_per_epoch: int,
                      window_batch: int = 1):
        """Grouped SGD over `model`'s parameters. With B windows a step the
        schedule is multiplied by B (tscd_base.py:178-194: the LR is
        basic_lr_per_img x the global batch, and batch_size is one
        window's frames)."""
        from ..train.optim import GroupedSGD
        sched = self.get_lr_schedule(iters_per_epoch)
        if window_batch > 1:
            base = sched
            sched = lambda i: base(i) * window_batch  # noqa: E731
        return GroupedSGD(model.named_parameters(), sched,
                          momentum=self.momentum, weight_decay=self.weight_decay,
                          freeze_prefixes=self.freeze_prefixes(),
                          stem_lr_prefixes=self.stem_lr_prefixes(),
                          stem_lr_ratio=self.stem_lr_ratio)

    def _vid_dataset(self, val: bool, lframe: int, gframe: int):
        """The train (val False) or val windows (tscd_base.py:196-216): an
        OVISVideoDataset on the OVIS json where dataset_name is "ovis",
        else a VIDDataset on the seq lists."""
        from ..data.vid import OVISVideoDataset, VIDDataset
        size = self.test_size if val else self.input_size
        if self.dataset_name == "ovis":
            return OVISVideoDataset(
                json_path=self.ovis_val_json if val else self.ovis_train_json,
                data_dir=self.data_dir, name=self.ovis_name, img_size=size,
                lframe=lframe, gframe=gframe, val=val, mode=self.mode, training=not val)
        if self.dataset_name != "vid":
            raise ValueError(f"dataset_name {self.dataset_name!r}: 'vid' or 'ovis'")
        return VIDDataset(
            file_path=self.val_seq_path if val else self.train_seq_path, img_size=size,
            lframe=lframe, gframe=gframe, val=val, mode=self.mode, dataset_pth=self.data_dir,
            tnum=self.tnum, traj_linking=val and self.traj_linking,
            local_stride=self.local_stride, cache_file=self.anno_cache, training=not val,
            formal=val)

    def get_train_dataset(self):
        """The training windows."""
        return self._vid_dataset(False, self.lframe, self.gframe)

    def get_data_loader(self, no_aug: bool = False, pin_memory: bool = False,
                        rng: Optional[np.random.Generator] = None,
                        dataset=None, batch_windows: int = 1):
        """Shuffled training windows of `dataset` (`get_train_dataset()`
        unless given; tscd_base.py get_data_loader): up to 120 cxcywh
        labels a frame, the window's own frame index as time, and unless
        `no_aug` the window's HSV jitter and flip, drawn from `rng`; with
        `batch_windows` B > 1, B windows stacked a batch. Uint8 frames,
        pinned for a CUDA device."""
        from ..data.vid import WindowLoader
        ds = dataset if dataset is not None else self.get_train_dataset()
        return WindowLoader(ds, pin_memory=pin_memory, shuffle=True,
                            train_time_index=True, cxcywh=True,
                            augment=not no_aug, hsv_prob=self.hsv_prob,
                            flip_prob=self.flip_prob, rng=rng,
                            batch_windows=batch_windows)

    def get_trainer(self, args=None, device=None):
        from ..core.tscd_trainer import TSCDTrainer
        return TSCDTrainer(self, args, device=device)

    def get_eval_loader(self, lframe: Optional[int] = None,
                        gframe: Optional[int] = None,
                        pin_memory: bool = False):
        """The val windows (tscd_base.py:223), VID or OVIS as
        `dataset_name` says. `pin_memory` for a CUDA
        predict device: windows arrive in pinned memory."""
        from ..data.vid import WindowLoader
        ds = self._vid_dataset(True, lframe or self.lframe_val, gframe or self.gframe_val)
        dtype = np.uint8 if self.eval_uint8_transport else np.float32
        return WindowLoader(ds, img_dtype=dtype, pin_memory=pin_memory)

    def get_predict_fn(self, model):
        """The streaming evaluator's predict function for `model` on the
        exp's val windows (`core.predict.make_predict_fn`)."""
        from ..core.predict import make_predict_fn
        return make_predict_fn(model, self.lframe_val, self.gframe_val, self.nmsthre,
                               self.test_conf)

    def get_evaluator(self, val_loader=None):
        """tscd_base.py:238."""
        from ..eval.vid_evaluator import OVISEvaluator, VIDEvaluator
        cls = OVISEvaluator if self.dataset_name == "ovis" else VIDEvaluator
        return cls(val_loader or self.get_eval_loader(),
                   img_size=self.test_size, confthre=self.test_conf,
                   nmsthre=self.nmsthre, num_classes=self.num_classes,
                   lframe=self.lframe_val, gframe=self.gframe_val,
                   traj_linking=self.traj_linking)
