"""Model EMA (counterpart of tscd_tpu/train/ema.py; reference
yolox/utils/ema.py:22): decay(t) = d (1 - exp(-t / 2000)) with t the
update count after the increment, over the parameters and floating
buffers (JAX's params and batch_stats); an integer buffer takes the new
value. Where the optimizer holds fp32 masters of a bf16 model
(`GroupedSGD.masters`), the EMA starts from and moves towards the
masters, as JAX's EMA does over its fp32 params; so every floating entry
of the EMA is fp32."""

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def ema_decay(step: int, decay: float = 0.9998) -> np.float32:
    """The step's decay in fp32, as JAX computes it."""
    f32 = np.float32
    return f32(decay) * (f32(1) - np.exp(-f32(step) / f32(2000)))


def _state(model: nn.Module, masters: Optional[Mapping[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    return {**model.state_dict(), **(masters or {})}


class ModelEMA:
    """A copy of the model's state_dict (its `masters` in their
    parameters' places), moved towards the model by `update(model,
    step, masters)`."""

    def __init__(self, model: nn.Module, decay: float = 0.9998,
                 masters: Optional[Mapping[str, torch.Tensor]] = None):
        self.decay = decay
        self.state: Dict[str, torch.Tensor] = {
            k: v.detach().clone() for k, v in _state(model, masters).items()}

    @torch.no_grad()
    def update(self, model: nn.Module, step: int,
               masters: Optional[Mapping[str, torch.Tensor]] = None):
        d = float(ema_decay(step, self.decay))
        keep = float(np.float32(1) - np.float32(d))
        new = _state(model, masters)
        floats = [k for k, e in self.state.items() if e.is_floating_point()]
        ema = [self.state[k] for k in floats]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            [new[k].detach().to(self.state[k].dtype) for k in floats], keep))
        for k, e in self.state.items():
            if not e.is_floating_point():
                e.copy_(new[k])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.state
