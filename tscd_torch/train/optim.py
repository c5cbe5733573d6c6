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

fp32 masters: flax keeps every parameter in fp32 (`param_dtype`) and
casts it to the compute dtype at each call, so JAX's SGD, EMA and
checkpoints see fp32 parameters. A port model at bf16 stores its conv and
Linear weights in bf16 (the eval path's CUDA graph reads them as they
are), so the optimizer holds an fp32 master of each parameter stored in
another dtype: the forward reads the master's bf16 rounding, as flax's
cast gives it; each gradient is cast up to fp32 before the clip, the
decay and Nesterov (JAX's gradient is the bf16 cotangent cast up by the
VJP of that cast); after the update the master is copied, rounded, into
the bf16 weight.
"""

from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

from ..utils.convert import flax_param_path, yolov_towers

FROZEN = "frozen"
CLIP_GRAD_NORM = 35.0     # build_sgd's default, the recipe's value


def label_params(named_params: Iterable[Tuple[str, torch.Tensor]],
                 freeze_prefixes: Sequence[str] = (),
                 stem_lr_prefixes: Sequence[str] = ()) -> Dict[str, str]:
    """{port name: 'frozen' | 'weight' | 'no_decay' | 'stem_weight' |
    'stem_no_decay'}, as `_label_params` labels each flax path."""
    named_params = list(named_params)
    towers = yolov_towers(n for n, _ in named_params)
    labels = {}
    for name, p in named_params:
        path = flax_param_path(name, p.dim(), towers)
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
    ratio before the step.

    `masters` holds the fp32 master of every parameter not stored in
    fp32, frozen ones too (their fp32 values are what JAX's EMA and
    checkpoint hold): taken from `masters` where the caller gives them
    (an fp32 state_dict), else from the stored values; the parameter is
    set to the master's rounding. SGD updates the masters in their place."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 schedule: Callable[[int], float], momentum: float = 0.9,
                 weight_decay: float = 5e-4,
                 freeze_prefixes: Sequence[str] = (),
                 stem_lr_prefixes: Sequence[str] = (),
                 stem_lr_ratio: float = 1.0,
                 masters: Optional[Mapping[str, torch.Tensor]] = None):
        self.params = dict(named_params)
        self.labels = label_params(self.params.items(), freeze_prefixes,
                                   stem_lr_prefixes)
        self.schedule = schedule
        self.trained = [n for n in self.params if self.labels[n] != FROZEN]
        self.masters: Dict[str, torch.Tensor] = {}
        for n, p in self.params.items():
            if p.dtype != torch.float32:
                src = masters[n] if masters is not None and n in masters else p
                self.masters[n] = src.detach().to(p.device, torch.float32, copy=True)
        self._sync()
        # the tensors SGD updates: the master where there is one
        self.updated = {n: self.masters.get(n, self.params[n]) for n in self.trained}
        groups = []
        for label in ("weight", "no_decay", "stem_weight", "stem_no_decay"):
            ps = [self.updated[n] for n in self.trained if self.labels[n] == label]
            if ps:
                groups.append({"params": ps,
                               "ratio": stem_lr_ratio if label.startswith("stem") else 1.0,
                               "weight_decay": weight_decay if label.endswith("weight") else 0.0})
        self.sgd = torch.optim.SGD(groups or [{"params": [], "ratio": 1.0}], lr=0.0,
                                   momentum=momentum, nesterov=True)
        # {name: momentum buffer}: the SGD's own state tensors
        self.trace = {}
        for n, p in self.updated.items():
            self.trace[n] = self.sgd.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.count = 0

    @torch.no_grad()
    def _sync(self, names: Optional[Iterable[str]] = None):
        """Each master's rounding into its parameter."""
        for n in self.masters if names is None else names:
            self.params[n].copy_(self.masters[n])

    @torch.no_grad()
    def accumulate(self):
        """Moves the gradient of each parameter that has a master into the
        master's, cast to fp32 and added to what it holds, and clears the
        parameter's: a step over several windows calls it after each
        window's backward, so that the windows' gradients sum in fp32."""
        for n in self.trained:
            p = self.params[n]
            if n in self.masters and p.grad is not None:
                m = self.masters[n]
                g = p.grad.to(torch.float32)
                m.grad = g if m.grad is None else m.grad + g
                p.grad = None

    def lr(self, count: Optional[int] = None) -> float:
        return float(self.schedule(self.count if count is None else count))

    @torch.no_grad()
    def step(self):
        self.accumulate()
        params = [self.updated[n] for n in self.trained]
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
        self._sync(n for n in self.trained if n in self.masters)
        for m in self.masters.values():
            m.grad = None
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "trace": {n: t.detach().cpu() for n, t in self.trace.items()}}

    def load_state_dict(self, state: Dict, log=print) -> bool:
        """Restores the count and the momentum traces. A state read from a
        JAX checkpoint (with "labels") restores only where its groups are
        these, every trained parameter in the same group at the same shape;
        otherwise it restores nothing and returns False, as JAX's
        restore_opt_state keeps the fresh init. A port state restores each
        trace whose name and shape match; the rest keep their zeros, with a
        warning (tolerant, as `restore_opt_state`)."""
        saved = state.get("trace", {})
        if "labels" in state:
            same = (state.get("count") is not None
                    and state["labels"] == {n: self.labels[n] for n in self.trained}
                    and all(tuple(saved[n].shape) == tuple(t.shape)
                            for n, t in self.trace.items()))
            if not same:
                log("the checkpoint's optimizer groups are not this optimizer's; "
                    "keeping its fresh state")
                return False
        self.count = int(state.get("count", 0))
        for n, t in self.trace.items():
            if n in saved and tuple(saved[n].shape) == tuple(t.shape):
                t.copy_(saved[n])
            else:
                log(f"optimizer trace of {n} not in the checkpoint, kept at 0")
        return True
