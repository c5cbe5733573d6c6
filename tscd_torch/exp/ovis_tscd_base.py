"""TSCD on OVIS, stage 2 of the OVIS recipe (exps/TSCD_OVIS/ovis_tscd_base.py
and ovis_tscd_large.py): 25 classes, training windows of 4 + 12 frames,
eval windows of 8 + 24, the per-frame json under data_dir. Stage 1's
checkpoint (`yolox_base`'s `ovis_yolox_l`, trained with `tools/train.py`)
loads with `tscd_train -c`."""

from ..data import FIXTURES
from .tscd_base import TSCDExp
from .tscd_large import SelftestExp


class Exp(TSCDExp):
    """TSCD-Base on OVIS: depth 0.33, width 0.5."""

    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
        self.num_classes = 25
        self.dataset_name = "ovis"
        self.lframe = 4
        self.gframe = 12
        self.lframe_val = 8
        self.gframe_val = 24
        self.data_dir = "./datasets/OVIS"
        self.ovis_train_json = "./datasets/OVIS/annotations_train.json"
        self.ovis_val_json = "./datasets/OVIS/annotations_valid.json"
        self.ovis_name = "train"
        self.exp_name = "ovis_tscd_base"


class LargeExp(Exp):
    """TSCD-Large on OVIS: depth 1.0, width 1.0."""

    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
        self.exp_name = "ovis_tscd_large"


class OVISSelftestExp(SelftestExp):
    """Stage 2 at the selftest size (depth 0.33, width 0.125, P = 6, 128
    px) on the committed OVIS-format fixture: 25 classes, training windows
    of 2 + 2 frames, eval windows of 2 + 6."""

    def __init__(self):
        super().__init__()
        self.num_classes = 25
        self.dataset_name = "ovis"
        self.data_dir = f"{FIXTURES}/vid"
        self.ovis_name = "Data/VID/val"
        self.ovis_train_json = f"{FIXTURES}/ovis/annotations_train.json"
        self.ovis_val_json = f"{FIXTURES}/ovis/annotations_valid.json"
        self.lframe_val, self.gframe_val = 2, 6
        self.exp_name = "ovis_selftest"
