"""Weights carried across: JAX/flax variables and reference `.pth` files
into the port.

The port's parameter names are the reference's torch `state_dict` names,
so a reference `.pth` loads as it is (`load_reference_pth`). For flax
variables, `state_dict_from_flax` maps each key of the port's state_dict
to its flax path with this module's copy of the name rules of
tscd_tpu/utils/convert.py (torch_to_flax), then changes the layout:
HWIO kernel -> OIHW conv weight, (in, out) kernel -> (out, in) linear
weight, BN scale/bias/mean/var -> weight/bias/running_mean/running_var,
LayerNorm scale -> weight.
"""

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _translate_backbone(parts):
    """Translate CSPDarknet/PAFPN segment names."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("dark2", "dark3", "dark4", "dark5"):
            idx = parts[i + 1]
            if p == "dark5":
                sub = {"0": "conv", "1": "spp", "2": "csp"}[idx]
            else:
                sub = {"0": "conv", "1": "csp"}[idx]
            out.append(f"{p}_{sub}")
            i += 2
        elif p == "m" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"m_{parts[i + 1]}")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _translate_head(parts):
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("stems", "cls_preds", "reg_preds", "obj_preds"):
            k = parts[i + 1]
            base = {"stems": "stem", "cls_preds": "cls_pred",
                    "reg_preds": "reg_pred", "obj_preds": "obj_pred"}[p]
            out.append(f"{base}_{k}")
            i += 2
        elif p in ("cls_convs", "reg_convs", "cls_convs2", "reg_convs2"):
            k, j = parts[i + 1], parts[i + 2]
            base = {"cls_convs": "cls_conv", "reg_convs": "reg_conv",
                    "cls_convs2": "cls_conv2",
                    "reg_convs2": "reg_conv2"}[p]
            out.append(f"{base}_{k}_{j}")
            i += 3
        elif p == "edge_enhance_reg":
            k = parts[i + 1]
            out.append(f"edge_{k}")
            # skip the Sequential index (always 0)
            i += 3 if i + 2 < len(parts) and parts[i + 2] == "0" else 2
        elif p == "filter1" or p == "filter2":
            out.append(p)
            # skip Sequential conv index
            if i + 1 < len(parts) and parts[i + 1] == "0":
                i += 2
            else:
                i += 1
        else:
            out.append(p)
            i += 1
    return out


_QKV_NAMES = ("q_cls_local", "kv_cls", "q_reg_local", "kv_reg")


def _translate_video(parts):
    """Translate TSCD video-stack segment names (aggregation + matcher +
    task-aligned), for the modules the port has."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "mca" and i + 1 < len(parts) and parts[i + 1] in _QKV_NAMES:
            # the projections live on the flax DualBranchAttention 'attn'
            out.extend(["mca", "attn"])
            i += 1
        elif p == "transformer_aware_cross_attention_layers":
            out.append(f"layer_{parts[i + 1]}")
            i += 2
        elif p == "transformer_cross_attention_layers":
            # TaskAligned: layer j -> attn_j / norm_j
            j = parts[i + 1]
            rest = parts[i + 2:]
            if rest and rest[0] == "multihead_attn":
                out.append(f"attn_{j}")
                i += 3
            elif rest and rest[0] == "norm":
                out.append(f"norm_{j}")
                i += 3
            else:
                out.append(f"layer_{j}")
                i += 2
        elif p == "multihead_attn":
            out.append("attn")
            i += 1
        elif p == "fc" and i + 1 < len(parts) and parts[i + 1] in ("0", "2"):
            # SEModule Sequential(Linear, ReLU, Linear) -> fc1/fc2
            out.append("fc1" if parts[i + 1] == "0" else "fc2")
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def flax_module_path(name: str) -> Tuple[str, ...]:
    """Port / reference parameter name without its leaf -> flax module
    path, e.g. 'head.agg.mca.kv_cls.weight' -> ('head', 'agg', 'mca',
    'attn', 'kv_cls')."""
    parts = name.split(".")[:-1]
    return tuple(_translate_video(_translate_head(_translate_backbone(parts))))


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def flax_param_path(name: str, ndim: int) -> Tuple[str, ...]:
    """A port parameter's flax `params` path, leaf included: the module
    path of `flax_module_path` and the leaf flax names it by (`kernel` for
    a conv or Linear weight of `ndim` 4 or 2, `scale` for a BatchNorm or
    LayerNorm weight)."""
    path = flax_module_path(name)
    leaf = name.split(".")[-1]
    if path and path[-1] == "bn":
        return path + (_BN_LEAVES[leaf][1],)
    if leaf == "weight":
        return path + (("kernel",) if ndim in (2, 4) else ("scale",))
    return path + (leaf,)


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """{path tuple: leaf} of a nested dict (empty dicts give no leaf)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def state_dict_from_flax(variables: Mapping[str, Mapping],
                         template: Mapping[str, torch.Tensor],
                         strict: bool = True) -> Dict[str, torch.Tensor]:
    """JAX {'params', 'batch_stats'} tree (numpy arrays) -> the port's
    state_dict. `template` is the port model's own state_dict: it gives
    the keys, shapes and dtypes; num_batches_tracked is kept from it. With
    `strict` False a key the tree lacks, or holds at another shape, is left
    out (for a shape-tolerant load) instead of raising."""
    coll = {c: flatten_tree(variables.get(c, {})) for c in ("params", "batch_stats")}
    out: Dict[str, torch.Tensor] = {}
    for name, ref in template.items():
        leaf = name.split(".")[-1]
        if leaf == "num_batches_tracked":
            out[name] = ref.clone()
            continue
        path = flax_module_path(name)
        if path and path[-1] == "bn":
            c, key = _BN_LEAVES[leaf]
        elif leaf == "weight":
            c, key = "params", ("kernel" if ref.dim() in (2, 4) else "scale")
        else:
            c, key = "params", leaf
        if not strict and path + (key,) not in coll[c]:
            continue
        arr = np.asarray(coll[c][path + (key,)])
        if leaf == "weight" and ref.dim() == 4:         # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "weight" and ref.dim() == 2:       # (in,out) -> (out,in)
            arr = arr.T
        t = torch.from_numpy(np.array(arr, copy=True)).to(ref.dtype)
        if t.shape != ref.shape:
            if not strict:
                continue
            raise ValueError(f"{name}: flax {tuple(t.shape)} != port "
                             f"{tuple(ref.shape)}")
        out[name] = t
    return out


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint's model state_dict, on the CPU
    (weights_only). Load it with `model.load_state_dict(sd,
    strict=False)`: its extra keys are the reference modules the port
    has no counterpart for."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckpt.get("model", ckpt))
