"""Inference-time transforms (counterpart of
tscd_tpu/utils/model_utils.py: `fuse_conv_bn_params` :45 and
`fused_batch_stats` :78; reference model_utils.py fuse_conv_and_bn and
fuse_model).

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

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models.blocks import BaseConv

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
