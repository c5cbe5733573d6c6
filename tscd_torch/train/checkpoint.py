"""Checkpoints (counterpart of tscd_tpu/train/checkpoint.py; reference
yolox/utils/checkpoint.py) in the port's own torch format: one
`torch.save`d dict of tensors and numbers, `<name>_ckpt.pth` with a
`best_ckpt.pth` copy. Its "model" entry is a state_dict, as in the
reference's files, so `utils.convert.load_reference_pth` reads it.

`load_checkpoint` also reads the JAX package's msgpack checkpoints (a
`.msgpack` path, read by `utils.flax_msgpack`, no flax needed) into that
format for a given model: "params" and "batch_stats" (the EMA weights a
JAX trainer saves, or a bare variables tree) become "model", "raw_params"
"raw_model", "start_epoch" stays, and optax's Nesterov traces in
"opt_state" become the port's "optimizer" entry (`GroupedSGD` takes them
where its groups are the checkpoint's).
"""

import os
import shutil
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch

from ..utils.convert import flatten_tree, state_dict_from_flax
from ..utils.flax_msgpack import read_msgpack


def save_checkpoint(state: Mapping[str, Any], save_dir: str,
                    is_best: bool = False, name: str = "latest") -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}_ckpt.pth")
    torch.save(_to_cpu(state), path)
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, "best_ckpt.pth"))
    return path


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Mapping):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def load_checkpoint(path: str, model: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """A port `.pth` checkpoint, or a JAX `.msgpack` one mapped onto
    `model`'s names (which it then needs)."""
    if not str(path).endswith(".msgpack"):
        return torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        raise ValueError(f"{path}: a JAX checkpoint is read onto a model's names; pass the model")
    return checkpoint_from_flax(read_msgpack(path), model)


def checkpoint_from_flax(tree: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, Any]:
    """A JAX checkpoint's tree (tscd_tpu/core/tscd_trainer.py:save_ckpt, or
    variables) -> the port's checkpoint dict for `model`. Weights map
    shape-tolerantly: a name the tree lacks is left out."""
    template = model.state_dict()
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, Any] = {"model": state_dict_from_flax(
        {"params": params, "batch_stats": tree.get("batch_stats", {})}, template, strict=False)}
    if "raw_params" in tree:
        out["raw_model"] = state_dict_from_flax(
            {"params": tree["raw_params"], "batch_stats": tree.get("batch_stats", {})},
            template, strict=False)
    if "start_epoch" in tree:
        out["start_epoch"] = int(tree["start_epoch"])
    if "opt_state" in tree:
        out["optimizer"] = optimizer_state_from_optax(tree["opt_state"], model.named_parameters())
    return out


def _under(tree: Any, key: str):
    """Every value stored under `key` anywhere in a nested dict."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if k == key:
                yield v
            else:
                yield from _under(v, key)


def optimizer_state_from_optax(opt_state: Mapping[str, Any],
                               named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """build_sgd's optax state (its to_state_dict) -> {"count", "trace":
    {port name: momentum trace, in the port's layout}, "labels": {port
    name: the group it was in}}. Each group of a multi_transform holds a
    Nesterov trace over the whole parameter tree, empty where a parameter
    is another group's, and its schedule's count. A trace the port has no
    parameter for leaves "count" None, so that the load sees the
    mismatch."""
    template = dict(named_params)
    trace, labels, counts = {}, {}, set()
    unknown = 0
    for inner in _under(opt_state, "inner_states"):
        for label, st in inner.items():
            for tr in _under(st, "trace"):
                got = state_dict_from_flax({"params": tr}, template, strict=False)
                unknown += len(flatten_tree(tr)) - len(got)
                trace.update(got)
                labels.update(dict.fromkeys(got, label))
            counts.update(int(c) for c in _under(st, "count"))
    count = counts.pop() if len(counts) == 1 and not unknown else None
    return {"count": count, "trace": trace, "labels": labels}


def load_tolerant(target: Mapping[str, torch.Tensor],
                  ckpt: Mapping[str, torch.Tensor],
                  log=print) -> Dict[str, torch.Tensor]:
    """`target` with each entry of `ckpt` of the same name and shape taken
    over (cast to the target's dtype); missing names and shape mismatches
    keep the target's value, with a warning (reference load_ckpt,
    checkpoint.py:11)."""
    out = {}
    for k, v in target.items():
        if k not in ckpt:
            log(f"{k} not in checkpoint, keeping init")
            out[k] = v
        elif tuple(ckpt[k].shape) != tuple(v.shape):
            log(f"shape mismatch at {k}: ckpt {tuple(ckpt[k].shape)} vs "
                f"model {tuple(v.shape)}, keeping init")
            out[k] = v
        else:
            out[k] = ckpt[k].to(v.dtype)
    return out
