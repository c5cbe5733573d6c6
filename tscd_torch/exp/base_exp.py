"""Experiment (config) base class (counterpart of
tscd_tpu/exp/base_exp.py; reference yolox/exp/base_exp.py:17): plain
attributes with factory methods, subclassed to override."""

import ast
from abc import ABCMeta, abstractmethod
from typing import Dict, Sequence


class BaseExp(metaclass=ABCMeta):
    seed = None

    @abstractmethod
    def get_model(self, device=None):
        pass

    def merge(self, cfg_list: Sequence[str]):
        """CLI `key value` override pairs, each coerced to the type of the
        attribute it replaces (reference base_exp.py:63)."""
        if len(cfg_list) % 2:
            raise ValueError(f"overrides must be key/value pairs, got {list(cfg_list)}")
        for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if k.startswith("--"):
                k = k[2:]
            if not hasattr(self, k):
                raise AttributeError(f"unknown exp attribute {k!r}")
            src_value = getattr(self, k)
            if src_value is not None and not isinstance(src_value, str):
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
                v = type(src_value)(v)
            setattr(self, k, v)
        return self

    def attrs(self) -> Dict:
        return {k: getattr(self, k) for k in dir(self)
                if not k.startswith("_") and not callable(getattr(self, k))}

    def __repr__(self):
        rows = [f"{'key':<24} value", "-" * 40]
        rows += [f"{k:<24} {v}" for k, v in sorted(self.attrs().items())]
        return "\n".join(rows)
