"""Every hand kernel as a torch op, in namespace `tscd`.

Each op is a `torch.library.custom_op` whose CPU implementation is the
kernel's plain version and whose CUDA implementation is the kernel's
launcher (which counts the launch in its wrapper's `.launches`); the fake
implementation gives each output's shape and dtype (contiguous, as every
implementation writes it), so `torch.export`,
`torch.compile` and AOTInductor trace through an op without running it,
and a traced graph holds `tscd::<op>` calls, never a plain version.
The wrappers in `ops/kernels/*.py` check their arguments and call these
ops; `csrc/torch_ops.cpp` registers the ops an exported YOLOX meets under
the same schemas, for a C++ process (the AOTInductor runner).

    tscd::focus_stem(x, w3, scale, shift)           the fp32 stem
    tscd::focus_stem_bf16(x, w3, scale, shift)      uint8 or fp32 frames -> bf16
    tscd::fused_dual_attention(qc, kc, vc, qr, kr, vr, cls_score, key_valid,
                               fg_score, scale)     both routes (split, stream)
    tscd::linear_sum_assignment(cost)
    tscd::nms_pack(boxes, iou_threshold)            the pack alone (checks)
    tscd::nms_sorted(boxes, valid, iou_threshold)   the pack, then the walk
    tscd::int8_absmax(x)
    tscd::int8_quantize(x, scale, mode)             0 dynamic, 1 channel, 2 row
    tscd::int8_conv(xq, wq, s_w, bias, sx, stride, pad, static_scale, act, out)

No op takes part in autograd: the wrappers that are differentiable wrap
the op in an `autograd.Function` (the stem, the attention, the int8 STE
conv), and the others take detached inputs.
"""

from typing import Optional, Tuple

import torch
from torch import Tensor

from . import focus_stem as fs
from . import fused_attention as fa
from . import hungarian as hu
from . import int8_conv as q8
from . import nms as kn

_op = torch.library.custom_op


# ------------------------------------------------------------------- stem

def _stem_fake(x, w3, scale, shift, dtype):
    return x.new_empty((x.shape[0], w3.shape[0], x.shape[1] // 2, x.shape[2] // 2),
                       dtype=dtype)


@_op("tscd::focus_stem", mutates_args=(), device_types="cpu")
def focus_stem(x: Tensor, w3: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    return fs.focus_stem_plain(x, w3, scale, shift, torch.float32).contiguous()


@focus_stem.register_kernel("cuda")
def _(x, w3, scale, shift):
    return fs.launch(x, w3, scale, shift, torch.float32)


@focus_stem.register_fake
def _(x, w3, scale, shift):
    return _stem_fake(x, w3, scale, shift, torch.float32)


@_op("tscd::focus_stem_bf16", mutates_args=(), device_types="cpu")
def focus_stem_bf16(x: Tensor, w3: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    return fs.focus_stem_plain(x, w3, scale, shift, torch.bfloat16).contiguous()


@focus_stem_bf16.register_kernel("cuda")
def _(x, w3, scale, shift):
    return fs.launch(x, w3, scale, shift, torch.bfloat16)


@focus_stem_bf16.register_fake
def _(x, w3, scale, shift):
    return _stem_fake(x, w3, scale, shift, torch.bfloat16)


# -------------------------------------------------------------- attention

@_op("tscd::fused_dual_attention", mutates_args=(), device_types="cpu")
def fused_dual_attention(qc: Tensor, kc: Tensor, vc: Tensor, qr: Tensor, kr: Tensor,
                         vr: Tensor, cls_score: Tensor, key_valid: Tensor,
                         fg_score: Optional[Tensor], scale: float
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    out = fa.fused_dual_attention_plain(qc, kc, vc, qr, kr, vr, cls_score, key_valid, scale,
                                        fg_score)
    return tuple(t.contiguous() for t in out)


@fused_dual_attention.register_kernel("cuda")
def _(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale):
    return fa.launch(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale)


@fused_dual_attention.register_fake
def _(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale):
    B, h, q, d = qc.shape
    k = kc.shape[2]
    f32 = torch.float32
    return (qc.new_empty((B, h, q, d), dtype=f32), qc.new_empty((B, h, q, d), dtype=f32),
            qc.new_empty((B, h, q, k), dtype=f32))


# ----------------------------------------------------------------- solver

@_op("tscd::linear_sum_assignment", mutates_args=(), device_types="cpu")
def linear_sum_assignment(cost: Tensor) -> Tensor:
    return hu.linear_sum_assignment_plain(cost).contiguous()


@linear_sum_assignment.register_kernel("cuda")
def _(cost):
    return hu.launch(cost)


@linear_sum_assignment.register_fake
def _(cost):
    return cost.new_empty(cost.shape[:2], dtype=torch.int32)


# -------------------------------------------------------------------- NMS

@_op("tscd::nms_pack", mutates_args=(), device_types="cpu")
def nms_pack(boxes: Tensor, iou_threshold: float) -> Tensor:
    return kn.pack_plain(boxes, iou_threshold).contiguous()


@nms_pack.register_kernel("cuda")
def _(boxes, iou_threshold):
    return kn.launch_pack(boxes, iou_threshold)


@nms_pack.register_fake
def _(boxes, iou_threshold):
    nb = (boxes.shape[1] + 31) // 32
    return boxes.new_empty((boxes.shape[0], nb * (nb + 1) // 2, 32), dtype=torch.int32)


@_op("tscd::nms_sorted", mutates_args=(), device_types="cpu")
def nms_sorted(boxes: Tensor, valid: Tensor, iou_threshold: float) -> Tensor:
    return kn.nms_sorted_plain(boxes, valid, iou_threshold).contiguous()


@nms_sorted.register_kernel("cuda")
def _(boxes, valid, iou_threshold):
    return kn.launch_sorted(boxes, valid, iou_threshold)


@nms_sorted.register_fake
def _(boxes, valid, iou_threshold):
    return valid.new_empty(valid.shape)


# ------------------------------------------------------------------- int8

@_op("tscd::int8_absmax", mutates_args=(), device_types="cpu")
def int8_absmax(x: Tensor) -> Tensor:
    return x.abs().amax().float().reshape(1)


@int8_absmax.register_kernel("cuda")
def _(x):
    return q8.launch_absmax(x)


@int8_absmax.register_fake
def _(x):
    return x.new_empty((1,), dtype=torch.float32)


@_op("tscd::int8_quantize", mutates_args=(), device_types="cpu")
def int8_quantize(x: Tensor, scale: Tensor, mode: int) -> Tensor:
    return q8.quantize_reference(x, scale, q8.MODE_NAMES[mode],
                                 clip=mode != q8.MODES["row"]).contiguous()


@int8_quantize.register_kernel("cuda")
def _(x, scale, mode):
    return q8.launch_quantize(x, scale, mode)


@int8_quantize.register_fake
def _(x, scale, mode):
    Fn, C, H, W = x.shape
    return x.new_empty((Fn, H, W, q8.padded_channels(C)), dtype=torch.int8)


@_op("tscd::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv(xq: Tensor, wq: Tensor, s_w: Tensor, bias: Tensor, sx: Tensor, stride: int,
              pad: int, static_scale: bool, act: int, out: int) -> Tensor:
    acc = q8.int8_conv_reference(xq, wq, stride, pad)
    if out == q8.OUT_INT32:
        return acc.contiguous()
    s = sx if static_scale else q8.dynamic_scale(sx)
    return q8.epilogue_reference(acc, s, s_w, bias, q8.ACTIVATIONS[act],
                                 q8.OUT_DTYPES[out]).contiguous()


@int8_conv.register_kernel("cuda")
def _(xq, wq, s_w, bias, sx, stride, pad, static_scale, act, out):
    return q8.launch_conv(xq, wq, s_w, bias, sx, stride, pad, static_scale, act, out)


@int8_conv.register_fake
def _(xq, wq, s_w, bias, sx, stride, pad, static_scale, act, out):
    Fn, H, W, _ = xq.shape
    k = wq.shape[1]
    return xq.new_empty((Fn, wq.shape[0], q8.out_size(H, k, stride, pad),
                         q8.out_size(W, k, stride, pad)),
                        dtype=torch.int32 if out == q8.OUT_INT32 else q8.OUT_DTYPES[out])


OPS = (focus_stem, focus_stem_bf16, fused_dual_attention, linear_sum_assignment, nms_pack,
       nms_sorted, int8_absmax, int8_quantize, int8_conv)


def schemas():
    """{op name: its schema string without the namespace}, as
    csrc/torch_ops.cpp must define them."""
    names = [op._name for op in OPS]
    return {n: str(getattr(torch.ops.tscd, n).default._schema).split("::", 1)[1]
            for n in names}
