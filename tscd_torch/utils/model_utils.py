"""Inference-time transforms (counterpart of
tscd_tpu/utils/model_utils.py: `fuse_conv_bn_params` :45 and
`fused_batch_stats` :78; reference model_utils.py fuse_conv_and_bn and
fuse_model), and the int8 serving mode's weight preparation
(`prepare_int8`, `set_int8_scales`).

Folding BatchNorm into the conv before it: the conv weight absorbs
gamma / sqrt(var + eps) per output channel and the BN becomes the bias
beta - mean * gamma / sqrt(var + eps). It is computed in fp32 on fp32
weights and only then cast to the compute dtype, as the JAX package
folds in numpy fp32 and casts at the op.

The JAX fold keeps the param tree and a BN with mean 0 and var 1, so its
folded forward still divides each conv output by sqrt(1 + 1e-5). The
port drops the BN instead (the conv gets a bias, `BaseConv.bn` is None),
so a folded port model equals the unfolded forward up to rounding and
differs from JAX's folded forward by that factor, about 5e-6 relative.
"""

import itertools
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models.blocks import BaseConv, Int8Weights, in_int8_scope, stamp_int8_paths

BN_EPS = 1e-5
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def fuse_conv_bn_state_dict(state_dict: Mapping[str, torch.Tensor],
                            eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Folds every `<p>.conv.weight` with its sibling `<p>.bn.*` (a
    BaseConv's) in fp32: `<p>.conv.weight` becomes the folded weight,
    `<p>.conv.bias` the BN's shift, and the `<p>.bn.*` keys are dropped.
    Other keys pass as they are. The same arithmetic, in the same order,
    as `fuse_conv_bn_params`."""
    out = dict(state_dict)
    f32 = torch.float32
    for key in state_dict:
        if not key.endswith(".conv.weight"):
            continue
        p = key[:-len("conv.weight")]
        if p + "bn.running_mean" not in state_dict:
            continue
        k = state_dict[key].to(f32)
        gamma, beta, mean, var = (state_dict[p + "bn." + n].to(f32)
                                  for n in _BN_LEAVES[:4])
        std = torch.sqrt(var + eps)
        out[key] = k * (gamma / std)[:, None, None, None]
        out[p + "conv.bias"] = beta - mean * gamma / std
        for n in _BN_LEAVES:
            out.pop(p + "bn." + n, None)
    return out


def fuse_model(model: nn.Module,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None
               ) -> nn.Module:
    """Folds the BN of every BaseConv of `model` into its conv, in place,
    and returns the model. The weights come from `state_dict`, the fp32
    state_dict of the unfolded model (a checkpoint, or an fp32 twin's),
    which is loaded whole, folded and cast to each parameter's dtype.
    Without it they come from the model itself, whose conv weights must
    then be fp32: a bf16 model's weights were rounded once on load, and
    folding them would round twice."""
    if state_dict is None:
        convs = [m.conv.weight for m in model.modules()
                 if isinstance(m, BaseConv) and m.bn is not None]
        if any(w.dtype != torch.float32 for w in convs):
            raise ValueError("fuse_model folds fp32 weights: pass the fp32 "
                             "state_dict of a model that computes in bf16")
        state_dict = model.state_dict()
    folded = fuse_conv_bn_state_dict(state_dict)
    for m in model.modules():
        if isinstance(m, BaseConv) and m.bn is not None:
            w = m.conv.weight
            m.conv.bias = nn.Parameter(torch.empty(
                w.shape[0], dtype=w.dtype, device=w.device))
            m.bn = None
    model.load_state_dict(folded)
    return model


_INT8_TOKENS = itertools.count(1)


def prepare_int8(model: nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 scope=None) -> nn.Module:
    """Prepares every groups-1 BaseConv of `model` for the int8 serving
    mode (`models.blocks.int8_eval`), or with `scope` (module-path
    prefixes, as `int8_eval(scope=...)` takes them) only those under it,
    the others left unprepared; in place, and returns the model: the
    BN-folded fp32 weight and bias, as JAX folds them at each int8 forward
    (blocks.py:266-272: s = gamma / sqrt(var + 1e-5), w s, beta - mean s;
    a BaseConv whose BN is folded already takes its fp32 weight and bias,
    JAX's `use_bias` branch), the packed int8 weights and their scales.
    They stay on each BaseConv, outside the state_dict, on its device, and
    replace any earlier preparation: call it again after new weights.

    The weights come from `state_dict`, the fp32 state_dict of the model
    (unfolded, or folded by `fuse_conv_bn_state_dict`), since JAX quantizes
    fp32 parameters and a bf16 model's conv weights were rounded on load.
    Without it they come from the model, whose conv weights must then be
    fp32. Static scales come after it, by `set_int8_scales`. It also stamps
    each BaseConv's path (`stamp_int8_paths`)."""
    stamp_int8_paths(model)
    scope = tuple(tuple(p) for p in scope) if scope is not None else None
    convs = []
    for n, m in model.named_modules():
        if isinstance(m, BaseConv) and m.conv.groups == 1:
            if in_int8_scope(m._int8_path, scope):
                convs.append((n, m))
            else:
                m._int8 = None
    if state_dict is not None:
        sd = fuse_conv_bn_state_dict(state_dict) if any(
            m.bn is None and (n + "." if n else "") + "bn.running_mean" in state_dict
            for n, m in convs) else state_dict
    else:
        if any(m.conv.weight.dtype != torch.float32 for _, m in convs):
            raise ValueError("prepare_int8 quantizes fp32 weights: pass the fp32 "
                             "state_dict of a model that computes in bf16")
        sd = model.state_dict()
    f32 = torch.float32
    for n, m in convs:
        dev = m.conv.weight.device
        p = n + "." if n else ""
        w = sd[p + "conv.weight"].to(dev, f32)
        if m.bn is not None:
            gamma, beta, mean, var = (sd[p + "bn." + k].to(dev, f32) for k in _BN_LEAVES[:4])
            s = gamma / torch.sqrt(var + BN_EPS)
            w_eff = w * s[:, None, None, None]
            b_eff = beta - mean * s
        else:
            w_eff = w
            b = sd.get(p + "conv.bias")
            b_eff = (b.to(dev, f32) if b is not None
                     else torch.zeros(w.shape[0], dtype=f32, device=dev))
        m._int8 = Int8Weights(w_eff.contiguous(), b_eff.contiguous())
    model._int8_token = next(_INT8_TOKENS)
    return model


def set_int8_scales(model: nn.Module, scales: Mapping[str, torch.Tensor]) -> nn.Module:
    """Gives the prepared BaseConvs of `model` (`prepare_int8`) their
    static route from calibrated scales ({BaseConv name: act_scale (C_in,)},
    `models.blocks.quantize_int8`'s result), in place, and returns the
    model. It touches only the scales and what is derived from them; a name
    that is not a prepared BaseConv raises."""
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, BaseConv) and m._int8 is not None}
    missing = [n for n in scales if n not in convs]
    if missing:
        raise KeyError(f"set_int8_scales: {missing[:5]} name no BaseConv prepared by "
                       "prepare_int8")
    for n, s in scales.items():
        convs[n]._int8.set_scales(s)
    model._int8_token = next(_INT8_TOKENS)
    return model
