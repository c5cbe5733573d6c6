"""Still-image YOLOX experiment (counterpart of tscd_tpu/exp/yolox_base.py;
reference yolox/exp/yolox_base.py:15), with every schedule and
augmentation knob of JAX's, and the built-in configurations of the repo's
`exps/default`, `exps/ovis_default` and `exps/yolov_ovis` (stage 1 of the
OVIS recipe). Runs on one card in fp32; the mesh knobs raise.
"""

import os
import random
from typing import Optional, Tuple

import numpy as np

from ..data import FIXTURES
from .base_exp import BaseExp


class YOLOXExp(BaseExp):
    def __init__(self):
        # model
        self.num_classes = 80
        self.depth = 1.00
        self.width = 1.00
        self.act = "silu"
        self.depthwise = False
        # JAX's trainer mesh (parallel/trainer_mesh.py): the port trains on
        # one card, so each raises above its default (`check_train_knobs`)
        self.mesh_data = 1
        self.mesh_model = 1
        self.fsdp = False
        # gradient accumulation: the batch in this many sequential chunks,
        # each with its own BN batch (train.step.yolox_train_step)
        self.grad_accum = 1
        # data
        self.data_dir = "./datasets/COCO"
        # the jsons are data_dir/ann_dir/train_ann and .../val_ann
        self.ann_dir = "annotations"
        self.train_ann = "instances_train2017.json"
        self.val_ann = "instances_val2017.json"
        self.train_name = "train2017"
        self.val_name = "val2017"
        self.input_size = (640, 640)
        self.multiscale_range = 5
        self.multiscale_step = 32        # still-image rule: +-range x 32
        self.enable_multiscale = False
        self.data_num_workers = 4
        self.flip_prob = 0.5
        self.hsv_prob = 1.0
        # mosaic and mixup
        self.mosaic_prob = 1.0
        self.mixup_prob = 1.0
        self.degrees = 10.0
        self.translate = 0.1
        self.mosaic_scale = (0.1, 2)
        self.mixup_scale = (0.5, 1.5)
        self.shear = 2.0
        self.enable_mixup = True
        # schedule
        self.warmup_epochs = 5
        self.max_epoch = 300
        self.warmup_lr = 0
        self.basic_lr_per_img = 0.01 / 64.0
        self.scheduler = "yoloxwarmcos"
        self.no_aug_epochs = 15
        self.min_lr_ratio = 0.05
        self.ema = True
        self.ema_decay = 0.9998
        self.momentum = 0.9
        self.weight_decay = 5e-4
        self.batch_size = 16
        self.print_interval = 10
        self.eval_interval = 10
        self.ckpt_interval = 1
        self.seed = None
        self.output_dir = "./YOLOX_outputs"
        self.exp_name = "yolox_base"
        # test
        self.test_size = (640, 640)
        self.test_conf = 0.01
        self.nmsthre = 0.65
        self.save_history_ckpt = True

    # -- factories ---------------------------------------------------------
    def get_model(self, device=None):
        """The YOLOX on `device`, the card unless the caller asks for another
        (torch's default init; the trainer seeds it)."""
        from ..models.yolox import YOLOX
        return YOLOX(num_classes=self.num_classes, depth=self.depth, width=self.width,
                     act=self.act, depthwise=self.depthwise, device=device)

    def get_dataset(self):
        from ..data.coco import COCODataset
        return COCODataset(json_file=os.path.join(self.data_dir, self.ann_dir, self.train_ann),
                           data_dir=self.data_dir, name=self.train_name,
                           img_size=self.input_size)

    def get_eval_dataset(self):
        from ..data.coco import COCODataset
        return COCODataset(json_file=os.path.join(self.data_dir, self.ann_dir, self.val_ann),
                           data_dir=self.data_dir, name=self.val_name,
                           img_size=self.test_size)

    def get_data_loader(self, batch_size: Optional[int] = None, no_aug: bool = False,
                        rng: Optional[random.Random] = None,
                        np_rng: Optional[np.random.RandomState] = None,
                        img_dtype=np.float32, dataset=None):
        """Mosaic, perspective, mixup and TrainTransform batches (mosaic and
        mixup off with `no_aug`), shuffled by random.Random(seed), the
        augmentation drawn from `rng` and `np_rng` (JAX's `random` and
        `np.random`)."""
        from ..data.coco import BatchLoader, MosaicDetection
        from ..data.transforms import TrainTransform
        ds = MosaicDetection(
            dataset if dataset is not None else self.get_dataset(), img_size=self.input_size,
            mosaic=not no_aug,
            preproc=TrainTransform(max_labels=120, flip_prob=self.flip_prob,
                                   hsv_prob=self.hsv_prob),
            degrees=self.degrees, translate=self.translate, mosaic_scale=self.mosaic_scale,
            mixup_scale=self.mixup_scale, shear=self.shear,
            enable_mixup=self.enable_mixup and not no_aug, mosaic_prob=self.mosaic_prob,
            mixup_prob=self.mixup_prob)
        return BatchLoader(ds, batch_size or self.batch_size, seed=self.seed or 0, rng=rng,
                           np_rng=np_rng, img_dtype=img_dtype)

    def get_lr_schedule(self, iters_per_epoch: int):
        from ..train.lr import cos_lr, multistep_lr, warm_cos_lr, yolox_warm_cos_lr
        lr = self.basic_lr_per_img * self.batch_size
        total = iters_per_epoch * self.max_epoch
        warm = iters_per_epoch * self.warmup_epochs
        if self.scheduler == "yoloxwarmcos":
            return yolox_warm_cos_lr(lr, self.min_lr_ratio, total, warm, self.warmup_lr,
                                     iters_per_epoch * self.no_aug_epochs)
        if self.scheduler == "warmcos":
            return warm_cos_lr(lr, total, warm)
        if self.scheduler == "cos":
            return cos_lr(lr, total)
        if self.scheduler == "multistep":
            return multistep_lr(lr, [total * 2 // 3, total * 5 // 6])
        raise ValueError(f"unknown scheduler {self.scheduler}")

    def get_optimizer(self, model, iters_per_epoch: int):
        """build_sgd's groups over `model`: weights decayed, biases and BN
        parameters not; no frozen or stem-LR group."""
        from ..train.optim import GroupedSGD
        return GroupedSGD(model.named_parameters(), self.get_lr_schedule(iters_per_epoch),
                          momentum=self.momentum, weight_decay=self.weight_decay)

    def get_evaluator(self, dataset=None):
        from ..eval.coco_evaluator import COCOEvaluator
        return COCOEvaluator(dataset or self.get_eval_dataset(), img_size=self.test_size,
                             confthre=self.test_conf, nmsthre=self.nmsthre,
                             num_classes=self.num_classes)

    def get_trainer(self, args=None, device=None):
        from ..core.trainer import Trainer
        return Trainer(self, args, device=device)

    def check_train_knobs(self):
        """Raises for JAX's mesh knobs (the port trains on one card) and
        where grad_accum does not divide the batch."""
        for knob in ("mesh_data", "mesh_model"):
            if int(getattr(self, knob) or 1) != 1:
                raise NotImplementedError(
                    f"{knob} = {getattr(self, knob)}: the port trains on one card "
                    "(ROADMAP queue 1 item 8)")
        if self.fsdp:
            raise NotImplementedError("fsdp: a mesh is not ported yet (ROADMAP queue 1 item 8)")
        accum = int(self.grad_accum or 1)
        if self.batch_size % accum:
            raise ValueError(f"grad_accum({accum}) must divide batch_size({self.batch_size})")

    def random_input_size(self, rng: random.Random) -> Tuple[int, int]:
        """A multiscale size (yolox_base.py:171): step x k, k drawn from
        `rng` within +-multiscale_range of input_size / step, the width
        scaled by the input's aspect."""
        step = self.multiscale_step
        base = self.input_size[0] // step
        k = rng.randint(base - self.multiscale_range, base + self.multiscale_range)
        size_factor = self.input_size[1] / self.input_size[0]
        return (step * k, step * int(k * size_factor))


class _OVISStill(YOLOXExp):
    """Stage 1 of the OVIS recipe: YOLOX fine-tuned on OVIS frames (25
    classes), its per-frame json at data_dir/<ann> (not under annotations/,
    as exps/ovis_default's factories read it), the frames under
    data_dir/train for both splits."""

    def __init__(self):
        super().__init__()
        self.num_classes = 25
        self.data_dir = "./datasets/OVIS"
        self.ann_dir = ""
        self.train_ann = "annotations_train.json"
        self.val_ann = "annotations_valid.json"
        self.train_name = "train"
        self.val_name = "train"


class OVISStillSelftestExp(_OVISStill):
    """Stage 1 at the selftest size on the committed OVIS-format fixture
    (tscd_torch/data/fixtures/ovis over vid's 32 frames of 1280 x 720):
    depth 0.33, width 0.125, 25 classes, 128 px, batches of 4, 2 epochs
    (one with mosaic and mixup, then the no-aug tail with L1), eval every
    epoch."""

    def __init__(self):
        super().__init__()
        self.depth, self.width = 0.33, 0.125
        self.data_dir = FIXTURES
        self.train_ann = "ovis/annotations_train.json"
        self.val_ann = "ovis/annotations_valid.json"
        self.train_name = self.val_name = "vid/Data/VID/val"
        self.input_size = self.test_size = (128, 128)
        self.batch_size = 4
        self.max_epoch, self.no_aug_epochs, self.warmup_epochs = 2, 1, 1
        self.eval_interval = 1
        self.print_interval = 4
        self.seed = 0
        self.exp_name = "ovis_still_selftest"


def _sized(name, base, depth, width, **extra):
    def init(self):
        base.__init__(self)
        self.depth, self.width = depth, width
        for k, v in extra.items():
            setattr(self, k, v)
        self.exp_name = name
    return type(name, (base,), {"__init__": init,
                                "__doc__": f"exps' {name}: depth {depth}, width {width}"
                                + "".join(f", {k} {v}" for k, v in extra.items())})


_TINY = dict(input_size=(416, 416), test_size=(416, 416), mosaic_scale=(0.5, 1.5),
             enable_mixup=False)
_OVIS_960 = dict(input_size=(640, 960), test_size=(640, 960), max_epoch=10, no_aug_epochs=2,
                 warmup_epochs=1, eval_interval=1, min_lr_ratio=0.05,
                 basic_lr_per_img=0.001 / 64.0, test_conf=0.001, nmsthre=0.5)

# the values of exps/default/*.py, exps/ovis_default/*.py and
# exps/yolov_ovis/yoloxl_ovis.py, yoloxs_ovis.py
STILL_EXPS = {
    "yolox_s": _sized("yolox_s", YOLOXExp, 0.33, 0.50),
    "yolox_m": _sized("yolox_m", YOLOXExp, 0.67, 0.75),
    "yolox_l": _sized("yolox_l", YOLOXExp, 1.0, 1.0),
    "yolox_x": _sized("yolox_x", YOLOXExp, 1.33, 1.25),
    "yolox_tiny": _sized("yolox_tiny", YOLOXExp, 0.33, 0.375, **_TINY),
    "yolox_nano": _sized("yolox_nano", YOLOXExp, 0.33, 0.25, depthwise=True, mosaic_prob=0.5,
                         **_TINY),
    "ovis_yolox_l": _sized("ovis_yolox_l", _OVISStill, 1.0, 1.0, input_size=(640, 640),
                           test_size=(576, 576), max_epoch=30, no_aug_epochs=5),
    "ovis_yolox_s": _sized("ovis_yolox_s", _OVISStill, 0.33, 0.5, max_epoch=7,
                           no_aug_epochs=2, warmup_epochs=1, seed=2024),
    "yoloxl_ovis": _sized("yoloxl_ovis", _OVISStill, 1.0, 1.0, **_OVIS_960),
    "yoloxs_ovis": _sized("yoloxs_ovis", _OVISStill, 0.33, 0.5, **_OVIS_960),
    "ovis_still_selftest": OVISStillSelftestExp,
}
