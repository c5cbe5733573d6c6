"""Exp loading by file path or built-in name (counterpart of
tscd_tpu/exp/build.py). An exp file defines `Exp`, a subclass of
`tscd_torch.exp.TSCDExp`; the repo's `exps/*.py` build on the JAX
package and do not load here."""

import importlib.util
import os

from .tscd_base import TSCDExp
from .tscd_large import Exp as TSCDLargeExp
from .tscd_large import SelftestExp
from .vid_tscd_base import Exp as TSCDBaseExp

BUILTIN = {"tscd_large": TSCDLargeExp, "tscd_base": TSCDBaseExp,
           "selftest": SelftestExp}


def get_exp_by_file(exp_file: str) -> TSCDExp:
    name = os.path.splitext(os.path.basename(exp_file))[0]
    spec = importlib.util.spec_from_file_location(f"tscd_torch_exp_{name}", exp_file)
    if spec is None:
        raise FileNotFoundError(exp_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    exp = module.Exp()
    if not isinstance(exp, TSCDExp):
        raise TypeError(f"{exp_file}: Exp must subclass tscd_torch.exp.TSCDExp")
    return exp


def get_exp_by_name(exp_name: str) -> TSCDExp:
    name = exp_name.replace("-", "_")
    if name not in BUILTIN:
        raise ValueError(f"unknown exp name {exp_name!r}; built in: {sorted(BUILTIN)}")
    return BUILTIN[name]()


def get_exp(exp_file=None, exp_name=None) -> TSCDExp:
    if exp_file is not None:
        return get_exp_by_file(exp_file)
    if exp_name is not None:
        return get_exp_by_name(exp_name)
    raise ValueError("give an exp file or an exp name")
