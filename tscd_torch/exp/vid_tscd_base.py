"""TSCD-Base on ImageNet VID (exps/TSCD_VID/vid_tscd_base.py): depth 0.33,
width 0.5, no warm-up epoch, otherwise the TSCD-Large recipe (4 + 12
frame training windows, 1 + 31 frame eval windows, 50 proposal slots,
MCA aggregation, decoupled reg, ota_mode refined labels)."""

from .tscd_base import TSCDExp


class Exp(TSCDExp):
    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.5
        self.warmup_epochs = 0
        self.exp_name = "vid_tscd_base"
