"""YOLOV / YOLOV++ experiments of the port (counterpart of
tscd_tpu/exp/yolov_base.py and the repo's exps/yolov, exps/yolov++,
exps/yolov_ovis/yolov*, exps/ovis_yolov_plus), on the TSCD exp's data,
training and eval attributes: windows of 0 local + 16 global frames to
train, 0 + 32 to evaluate, P = maximal_limit or minimal_limit or
defualt_p proposal slots (yolov_base.py:33-35), `model_family` "yolov"
(YOLOV: MSA over every frame) or "yolov_plus" (YOLOV++: agg_type,
decouple_reg).

JAX's `get_model` hands its model only the knobs the model takes
(yolov_base.py:29-49). The others stay at the model's own values there,
whatever the exp says: here each raises unless it is at that value
(`yolov_model_knobs`), and `use_pre_nms` defaults to None, the model's
own (YOLOV's pre-NMS on, YOLOV++'s off).
"""

import os
from typing import Dict, Optional, Tuple, Union

import torch

from .tscd_base import MODEL_KNOBS, TSCDExp


def yolov_model_knobs(family: str) -> Dict[str, Tuple[tuple, str]]:
    """{knob: (the values the port runs, why not another)} for a YOLOV
    family exp: the TSCD exp's six, and those JAX's YOLOV exp does not
    pass to this family's model."""
    why = (f"JAX's YOLOV exp does not pass it to its {family} model, so no other value has "
           "a JAX counterpart")
    knobs = {k: (v, why) for k, (v, _) in MODEL_KNOBS.items()}
    knobs.update({"cat_ota_fg": ((False,), why), "sparse_vid_towers": ((False,), why),
                  "remat_backbone": ((False,), why),
                  "use_pre_nms": ((None, family == "yolov"), why)})
    if family == "yolov":
        knobs.update({"agg_type": (("msa",), why), "decouple_reg": ((False,), why),
                      "conf_sim_thresh": ((0.99,), why)})
    return knobs


class YOLOVExp(TSCDExp):
    """YOLOV-L on ImageNet VID (exps/yolov/yolov_l.py): depth and width
    1.0, 30 classes, 4 heads, P = 30, sim_thresh 0.75."""

    def __init__(self):
        super().__init__()
        self.model_family = "yolov"        # "yolov" | "yolov_plus"
        self.lframe = 0
        self.gframe = 16
        self.lframe_val = 0
        self.gframe_val = 32
        self.defualt_p = 30
        self.minimal_limit = 30
        self.reconf = False
        self.decouple_reg = False
        self.agg_type = "msa"
        self.ota_mode = False
        self.use_pre_nms = None            # the model's own
        self.exp_name = "yolov_l"

    @property
    def num_proposals(self) -> int:
        return self.maximal_limit or self.minimal_limit or self.defualt_p

    def get_online_model(self, device: Optional[Union[str, torch.device]] = None):
        """YOLOVOnline on `device` (the card unless the caller asks for
        another) as the online demo builds it from a YOLOV exp
        (tools/yolov_demo_online.py:56-61): num_classes, depth, width,
        P = minimal_limit, heads, sim_thresh; random weights until loaded."""
        from ..models.yolov import YOLOVOnline
        return YOLOVOnline(num_classes=self.num_classes, depth=self.depth, width=self.width,
                           num_proposals=self.minimal_limit, heads=self.heads,
                           sim_thresh=self.sim_thresh, device=device)

    def get_model(self, device: Optional[Union[str, torch.device]] = None):
        """YOLOV or YOLOV++ on `device` (the card unless the caller asks for
        another), with the knobs JAX's get_model passes; raises for the
        others at another value than the model's (`yolov_model_knobs`).
        `stop_backbone_grad` (JAX's YOLOV has no such field) leaves the
        backbone's forward out of autograd: the same update, since the
        exp freezes the backbone (it raises where it does not)."""
        from ..models.yolov import YOLOV, YOLOVPlus
        if self.model_family not in ("yolov", "yolov_plus"):
            raise ValueError(f"model_family {self.model_family!r}: 'yolov' or 'yolov_plus'")
        for knob, (values, why) in yolov_model_knobs(self.model_family).items():
            if getattr(self, knob) not in values:
                raise NotImplementedError(
                    f"{knob} = {getattr(self, knob)!r}: the port's {self.model_family} runs "
                    f"{' or '.join(map(repr, values))}: {why}")
        if self.stop_backbone_grad and not any(
                p.startswith("backbone") for p in self.freeze_prefixes()):
            raise ValueError("stop_backbone_grad=True but freeze_prefixes() does not "
                             "freeze the backbone; set stop_backbone_grad=False "
                             "for a full fine-tune")
        kw = dict(num_classes=self.num_classes, depth=self.depth, width=self.width,
                  act=self.act, depthwise=self.depthwise, num_proposals=self.num_proposals,
                  heads=self.heads, reconf=self.reconf, sim_thresh=self.sim_thresh,
                  backbone_name=self.backbone_name,
                  stop_backbone_grad=self.stop_backbone_grad, device=device)
        if self.model_family == "yolov_plus":
            return YOLOVPlus(decouple_reg=self.decouple_reg, agg_type=self.agg_type,
                             conf_sim_thresh=self.conf_sim_thresh, **kw)
        return YOLOV(**kw)

    def get_trainer(self, args=None, device=None):
        from ..core.yolov_trainer import YOLOVTrainer
        return YOLOVTrainer(self, args, device=device)

    def get_predict_fn(self, model):
        """The YOLOV predict function (`core.yolov_trainer.make_predict_fn`)."""
        from ..core.yolov_trainer import make_predict_fn
        return make_predict_fn(model, self.lframe_val, self.gframe_val, self.nmsthre,
                               self.test_conf)


class YOLOVSExp(YOLOVExp):
    """YOLOV-S (exps/yolov/yolov_s.py): depth 0.33, width 0.5."""

    def __init__(self):
        super().__init__()
        self.depth, self.width = 0.33, 0.5
        self.exp_name = "yolov_s"


class VPlusBaseExp(YOLOVExp):
    """YOLOV++-Base (exps/yolov++/v++_base.py): depth 0.33, width 0.5,
    localagg, reconf, one aggregator, no warm-up."""

    def __init__(self):
        super().__init__()
        self.model_family = "yolov_plus"
        self.depth, self.width = 0.33, 0.5
        self.reconf = True
        self.ota_mode = True
        self.agg_type = "localagg"
        self.decouple_reg = False
        self.warmup_epochs = 0
        self.no_aug_epochs = 2
        self.eval_interval = 1
        self.stem_lr_ratio = 0.1
        self.exp_name = "v++_base"


class VPlusBaseDecoupleRegExp(VPlusBaseExp):
    """exps/yolov++/v++_base_decoupleReg.py: MSA and a second, decoupled
    MSA for the obj branch; minimal_limit 0, so P = defualt_p = 30."""

    def __init__(self):
        super().__init__()
        self.use_pre_nms = False
        self.cat_ota_fg = False
        self.agg_type = "msa"
        self.decouple_reg = True
        self.minimal_limit = 0
        self.seed = 2024
        self.exp_name = "v++_base_decoupleReg"


class VPlusBaseDecoupleReg2xExp(VPlusBaseDecoupleRegExp):
    """exps/yolov++/v++_base_decoupleReg_2x.py: 14 epochs."""

    def __init__(self):
        super().__init__()
        self.maximal_limit = 0
        self.max_epoch = 14
        self.exp_name = "v++_base_decoupleReg_2x"


class VPlusLargeExp(YOLOVExp):
    """exps/yolov++/v++_large.py: YOLOV++-L, MCA with the decoupled obj
    branch, windows of 4 + 12 frames to train and 1 + 31 to evaluate,
    P = 50."""

    def __init__(self):
        super().__init__()
        self.model_family = "yolov_plus"
        self.lframe, self.gframe = 4, 12
        self.lframe_val, self.gframe_val = 1, 31
        self.reconf = True
        self.decouple_reg = True
        self.agg_type = "mca"
        self.ota_mode = True
        self.minimal_limit = 50
        self.exp_name = "v_plus_large"


def _ovis(exp: YOLOVExp) -> YOLOVExp:
    """The OVIS data attributes of the OVIS exps."""
    exp.num_classes = 25
    exp.dataset_name = "ovis"
    exp.data_dir = "./datasets/OVIS"
    exp.ovis_train_json = "./datasets/OVIS/annotations_train.json"
    exp.ovis_val_json = "./datasets/OVIS/annotations_valid.json"
    exp.ovis_name = "train"
    return exp


class YOLOVLOVISExp(YOLOVExp):
    """exps/yolov_ovis/yolovl_ovis_75_75_750.py: YOLOV-L on OVIS at 640 x
    960, LR 0.001/64."""

    def __init__(self):
        super().__init__()
        _ovis(self)
        self.input_size = self.test_size = (640, 960)
        self.sim_thresh = 0.75
        self.pre_nms = 0.75
        self.defualt_pre = 750
        self.max_epoch = 7
        self.no_aug_epochs = 2
        self.warmup_epochs = 1
        self.eval_interval = 1
        self.min_lr_ratio = 0.05
        self.basic_lr_per_img = 0.001 / 64.0
        self.test_conf = 0.001
        self.nmsthre = 0.5
        self.exp_name = "yolovl_ovis_75_75_750"


class YOLOVSOVISExp(YOLOVLOVISExp):
    """exps/yolov_ovis/yolovs_ovis_75_75_750.py: depth 0.33, width 0.5."""

    def __init__(self):
        super().__init__()
        self.depth, self.width = 0.33, 0.5
        self.exp_name = "yolovs_ovis_75_75_750"


class OVISVPlusBaseExp(YOLOVExp):
    """exps/ovis_yolov_plus/v_plus_base.py: YOLOV++ (depth and width 1.0)
    on OVIS, localagg, reconf, one aggregator."""

    def __init__(self):
        super().__init__()
        _ovis(self)
        self.model_family = "yolov_plus"
        self.reconf = True
        self.ota_mode = True
        self.agg_type = "localagg"
        self.decouple_reg = False
        self.exp_name = "v_plus_base"


class OVISVPlusBaseDecoupleRegExp(YOLOVExp):
    """exps/ovis_yolov_plus/ovis_v++_base_decoupleReg.py: depth 0.33,
    width 0.5, MSA with the decoupled obj branch, P = maximal_limit = 500
    (minimal_limit 50)."""

    def __init__(self):
        super().__init__()
        _ovis(self)
        self.model_family = "yolov_plus"
        self.depth, self.width = 0.33, 0.5
        self.reconf = True
        self.ota_mode = True
        self.use_pre_nms = False
        self.cat_ota_fg = False
        self.agg_type = "msa"
        self.decouple_reg = True
        self.minimal_limit = 50
        self.maximal_limit = 500
        self.conf_sim_thresh = 0.99
        self.warmup_epochs = 0
        self.no_aug_epochs = 2
        self.eval_interval = 1
        self.stem_lr_ratio = 0.1
        self.seed = 2024
        self.exp_name = "ovis_v++_base_decoupleReg"


class OVISVPlusLargeDecoupleRegExp(OVISVPlusBaseDecoupleRegExp):
    """exps/ovis_yolov_plus/ovis_v++_large_decoupleReg.py: depth and width
    1.0. Its window (32 frames x 500 slots) runs the attention at q = k =
    16000, d 64, twice, on the kernel's streaming route (about 4.1 GB a
    launch: `attn` and the outputs)."""

    def __init__(self):
        super().__init__()
        self.depth, self.width = 1.0, 1.0
        self.exp_name = "ovis_v++_large_decoupleReg"


class YOLOVSelftestExp(YOLOVExp):
    """YOLOV at the size of the JAX package's YOLOV tests
    (tests/test_yolov.py) on the committed VID fixture (paths relative to
    the repo root): depth 0.33, width 0.125, P = 8, 2 heads, windows of
    0 + 4 frames at 64 px to evaluate and to train."""

    def __init__(self):
        super().__init__()
        fixture = "YOLOX_outputs/validate_ref/vid"
        self.depth, self.width = 0.33, 0.125
        self.heads = 2
        self.minimal_limit = self.maximal_limit = 8
        self.lframe, self.gframe = 0, 4
        self.lframe_val, self.gframe_val = 0, 4
        self.input_size = self.test_size = (64, 64)
        self.data_dir = fixture
        self.val_seq_path = self.train_seq_path = os.path.join(fixture, "val_seq.npy")
        self.seed = 0
        self.max_epoch, self.no_aug_epochs = 2, 1
        self.exp_name = "yolov_selftest"


YOLOV_EXPS = {
    "yolov_l": YOLOVExp, "yolov_s": YOLOVSExp, "v++_base": VPlusBaseExp,
    "v++_base_decoupleReg": VPlusBaseDecoupleRegExp,
    "v++_base_decoupleReg_2x": VPlusBaseDecoupleReg2xExp, "v++_large": VPlusLargeExp,
    "yolovl_ovis_75_75_750": YOLOVLOVISExp, "yolovs_ovis_75_75_750": YOLOVSOVISExp,
    "v_plus_base": OVISVPlusBaseExp, "ovis_v++_base_decoupleReg": OVISVPlusBaseDecoupleRegExp,
    "ovis_v++_large_decoupleReg": OVISVPlusLargeDecoupleRegExp,
    "yolov_selftest": YOLOVSelftestExp,
}
