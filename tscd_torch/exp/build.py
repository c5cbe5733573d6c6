"""Exp loading by file path or built-in name (counterpart of
tscd_tpu/exp/build.py). An exp file defines `Exp`, a subclass of one of
the port's exps (`tscd_torch.exp.TSCDExp` for video, `YOLOVExp` for the
YOLOV family, `YOLOXExp` for still images); the repo's `exps/*.py` build on the JAX package and do not load
here, and each of them has a built-in of the same name."""

import importlib.util
import os

from .base_exp import BaseExp
from .ovis_tscd_base import Exp as OVISTSCDBaseExp
from .ovis_tscd_base import LargeExp as OVISTSCDLargeExp
from .ovis_tscd_base import OVISSelftestExp
from .tscd_large import Exp as TSCDLargeExp
from .tscd_large import SelftestExp
from .vid_tscd_base import Exp as TSCDBaseExp
from .yolov_base import YOLOV_EXPS
from .yolox_base import STILL_EXPS

BUILTIN = {"tscd_large": TSCDLargeExp, "tscd_base": TSCDBaseExp, "selftest": SelftestExp,
           "ovis_tscd_base": OVISTSCDBaseExp, "ovis_tscd_large": OVISTSCDLargeExp,
           "ovis_selftest": OVISSelftestExp,
           **STILL_EXPS, **YOLOV_EXPS}


def get_exp_by_file(exp_file: str) -> BaseExp:
    name = os.path.splitext(os.path.basename(exp_file))[0]
    spec = importlib.util.spec_from_file_location(f"tscd_torch_exp_{name}", exp_file)
    if spec is None:
        raise FileNotFoundError(exp_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    exp = module.Exp()
    if not isinstance(exp, BaseExp):
        raise TypeError(f"{exp_file}: Exp must subclass one of the tscd_torch.exp exps")
    return exp


def get_exp_by_name(exp_name: str) -> BaseExp:
    name = exp_name.replace("-", "_")
    if name not in BUILTIN:
        raise ValueError(f"unknown exp name {exp_name!r}; built in: {sorted(BUILTIN)}")
    return BUILTIN[name]()


def get_exp(exp_file=None, exp_name=None) -> BaseExp:
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    if exp_name is not None:
        return get_exp_by_name(exp_name)
    raise ValueError("give an exp file or an exp name")
