"""Experiment configurations of the port."""

from .base_exp import BaseExp
from .build import get_exp, get_exp_by_file, get_exp_by_name
from .tscd_base import TSCDExp
from .tscd_large import Exp, SelftestExp, selftest_exp
from .vid_tscd_base import Exp as TSCDBaseExp
from .yolox_base import YOLOXExp

__all__ = ["BaseExp", "Exp", "SelftestExp", "TSCDBaseExp", "TSCDExp", "YOLOXExp", "get_exp",
           "get_exp_by_file", "get_exp_by_name", "selftest_exp"]
