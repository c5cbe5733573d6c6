"""Checkpoints (counterpart of tscd_tpu/train/checkpoint.py; reference
yolox/utils/checkpoint.py) in the port's own torch format: one
`torch.save`d dict of tensors and numbers, `<name>_ckpt.pth` with a
`best_ckpt.pth` copy. Its "model" entry is a state_dict, as in the
reference's files, so `utils.convert.load_reference_pth` reads it.
JAX's msgpack checkpoints need flax to read and are not read here."""

import os
import shutil
from typing import Any, Dict, Mapping

import torch


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


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


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
