"""TSCD-Large on ImageNet VID (exps/TSCD_VID/vid_tscd_large.py), and the
small selftest configuration of YOLOX_outputs/validate_ref."""

import os

from .tscd_base import TSCDExp

_FIXTURE = "YOLOX_outputs/validate_ref/vid"


class Exp(TSCDExp):
    """TSCD-Large: depth 1.0, width 1.0, P = 50, 1 + 31 frames, 576 px
    (the base's defaults)."""


class SelftestExp(TSCDExp):
    """The values of YOLOX_outputs/validate_ref/selftest_exp.py: depth
    0.33, width 0.125, P = 6, 1 + 3 frames, 128 px, on the committed VID
    fixture (paths relative to the repo root). Training windows of 2 + 2
    frames at 128 px on the same fixture's videos, HSV jitter and flip as
    TSCD-Large's, one epoch of warm-up in 2."""

    def __init__(self):
        super().__init__()
        self.depth, self.width = 0.33, 0.125
        self.minimal_limit = 6
        self.maximal_limit = 6
        self.lframe_val, self.gframe_val = 1, 3
        self.test_size = (128, 128)
        self.data_dir = _FIXTURE
        self.val_seq_path = os.path.join(_FIXTURE, "val_seq.npy")
        self.seed = 0
        self.lframe, self.gframe = 2, 2
        self.input_size = (128, 128)
        self.train_seq_path = self.val_seq_path
        self.max_epoch, self.no_aug_epochs = 2, 1
        self.exp_name = "selftest"


def selftest_exp() -> SelftestExp:
    return SelftestExp()
