"""Grouped SGD (counterpart of tscd_tpu/train/optim.py:build_sgd;
reference yolox_base.py:237 and vid_tscd_large.py:157).

Each parameter gets the group JAX's `_label_params` gives its flax path
(the port's names map onto flax paths through `utils.convert`):
'frozen' (a freeze prefix), 'stem_*' (a stem-LR prefix, LR x
stem_lr_ratio), and '*weight' (decayed) or '*no_decay' (every bias, BN
parameter and LayerNorm scale). One update, in optax's order: frozen
gradients zeroed (a parameter without a gradient counts as zero), all
gradients clipped by their global norm (scaled by max/norm only where
the norm reaches max, as `optax.clip_by_global_norm`, with no epsilon:
written out, as `clip_grad_norm_` adds one), then `torch.optim.SGD`:
weight decay added on decayed groups, Nesterov momentum (trace = g +
m trace; update = g + m trace), then -LR x ratio, the LR of update n
being schedule(n).
"""

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..utils.convert import flax_param_path

FROZEN = "frozen"
CLIP_GRAD_NORM = 35.0     # build_sgd's default, the recipe's value


def label_params(named_params: Iterable[Tuple[str, torch.Tensor]],
                 freeze_prefixes: Sequence[str] = (),
                 stem_lr_prefixes: Sequence[str] = ()) -> Dict[str, str]:
    """{port name: 'frozen' | 'weight' | 'no_decay' | 'stem_weight' |
    'stem_no_decay'}, as `_label_params` labels each flax path."""
    labels = {}
    for name, p in named_params:
        path = flax_param_path(name, p.dim())
        spath = "/".join(path)
        leaf, parent = path[-1], (path[-2] if len(path) > 1 else "")
        no_decay = leaf == "bias" or parent == "bn" or leaf == "scale"
        if any(spath.startswith(q) for q in freeze_prefixes):
            labels[name] = FROZEN
        elif any(spath.startswith(q) for q in stem_lr_prefixes):
            labels[name] = "stem_no_decay" if no_decay else "stem_weight"
        else:
            labels[name] = "no_decay" if no_decay else "weight"
    return labels


class GroupedSGD:
    """SGD with JAX's parameter groups over `named_params` (the model's
    `named_parameters()`). `step()` reads each parameter's `.grad`;
    `count` is the number of updates made (the schedule's argument).

    After the clip, the update is `torch.optim.SGD(nesterov=True)` with
    one param group a label: its weight decay, momentum and Nesterov step
    are optax's, and its buffers start at zero, so the first trace is the
    gradient, as optax's. Each group's LR is set to schedule(count) x
    ratio before the step."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 5e-4,
                 freeze_prefixes: Sequence[str] = (),
                 stem_lr_prefixes: Sequence[str] = (),
                 stem_lr_ratio: float = 1.0):
        self.params = dict(named_params)
        self.labels = label_params(self.params.items(), freeze_prefixes,
                                   stem_lr_prefixes)
        self.schedule = schedule
        self.trained = [n for n in self.params if self.labels[n] != FROZEN]
        groups = []
        for label in ("weight", "no_decay", "stem_weight", "stem_no_decay"):
            ps = [self.params[n] for n in self.trained if self.labels[n] == label]
            if ps:
                groups.append({"params": ps,
                               "ratio": stem_lr_ratio if label.startswith("stem") else 1.0,
                               "weight_decay": weight_decay if label.endswith("weight") else 0.0})
        self.sgd = torch.optim.SGD(groups or [{"params": [], "ratio": 1.0}], lr=0.0,
                                   momentum=momentum, nesterov=True)
        # {name: momentum buffer}: the SGD's own state tensors
        self.trace = {}
        for n in self.trained:
            p = self.params[n]
            self.trace[n] = self.sgd.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.count = 0

    def lr(self, count: Optional[int] = None) -> float:
        return float(self.schedule(self.count if count is None else count))

    @torch.no_grad()
    def step(self):
        params = [self.params[n] for n in self.trained]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < CLIP_GRAD_NORM, 1.0, CLIP_GRAD_NORM / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.lr()
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["ratio"]
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "trace": {n: t.detach().cpu() for n, t in self.trace.items()}}

    def load_state_dict(self, state: Dict, log=print):
        """Restores the count and each momentum trace whose name and shape
        match; the rest keep their fresh zeros, with a warning (tolerant,
        as `restore_opt_state`)."""
        self.count = int(state.get("count", 0))
        saved = state.get("trace", {})
        for n, t in self.trace.items():
            if n in saved and tuple(saved[n].shape) == tuple(t.shape):
                t.copy_(saved[n])
            else:
                log(f"optimizer trace of {n} not in the checkpoint, kept at 0")
