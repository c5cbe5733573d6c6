"""Eval Focus stem (kernel 3 of the port).

Replaces tscd_tpu/ops/pallas/focus_stem.py (`_focus_stem_impl` ->
`_kernel`); in the JAX package the same math runs as an XLA conv
(blocks.py:596). CUDA source: tscd_torch/csrc/focus_stem.cu. The stem,
space-to-depth + 3x3 conv + BN + SiLU, is one 6x6 stride-2 conv over the
raw (F, H, W, 3) image with the BN scale folded into the weights, then
+ shift and SiLU.

Bound on an H100 at (32, 576, 576, 3) -> 64 channels: fp32 frames in
and fp32 out move 127 MB read and 679 MB written (0.24 ms) against
36.7 GFLOP of fp32 FMA (0.55 ms at the 67 TFLOP/s non-tensor peak), so
operations bound the fp32 kernel (`focus_stem_kernel`). The bf16 variant
(`out_dtype=torch.bfloat16`, uint8 frames in) moves 31.85 MB in and
340 MB out (0.111 ms); its products of bf16 values run on the tensor
cores (`focus_stem_mma`, 0.037 ms at the bf16 rate), so bytes bound it.
The bf16 kernel takes its weights as mma.sync fragments
(`weight_fragments`).

The stem is differentiable in x, w3, scale and shift, as JAX's
`focus_stem` is a `custom_vjp` (focus_stem.py:207-221): the forward is
the kernel, the backward the VJP of a plain fp32 recompute of the 6x6
conv (`focus_stem_reference`, JAX's `_xla_reference` at its default fp32
compute), no kernel. The training path that records the stem with BN
folded is `stop_backbone_grad=False` under `fix_bn`.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import library


BACKWARD_RANGE = "focus_stem backward"


def rearrange_weight(w3: torch.Tensor, scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Focus conv weight (O, 4C, 3, 3) in torch layout, s2d channel order
    (dx*2+dy)*C + c, times the folded BN scale (O,) where given -> the
    equivalent 6x6 stride-2 kernel (O, C, 6, 6), with ky = 2u+dy and
    kx = 2v+dx."""
    O, C4, k, _ = w3.shape
    C = C4 // 4
    w6 = w3.reshape(O, 2, 2, C, k, k)                  # (o, dx, dy, c, u, v)
    w6 = w6.permute(0, 3, 4, 2, 5, 1).reshape(O, C, 2 * k, 2 * k)
    return w6 if scale is None else w6 * scale[:, None, None, None]


TAPS = 108       # the 6x6 kernel's taps, (ky, kx, c) order: k = (6 ky + kx) 3 + c
MMA_K = 112      # 7 k-steps of 16: the taps, then 3 that carry the shift and a zero
CHUNK = 32       # output channels of one warp of the bf16 kernel: two m16 tiles


def shift_parts(shift: torch.Tensor) -> torch.Tensor:
    """(O,) -> (O, 3) fp32 values, each exact in bf16, whose fp32 sum is the
    shift exactly: the shift cut to bf16's 8 significant bits, the
    remainder cut likewise, and the rest (8 + 8 + 8 bits cover fp32's 24)."""
    s = shift.to(torch.float32)
    hi = (s.view(torch.int32) & -65536).view(torch.float32)
    rest = s - hi
    mid = (rest.view(torch.int32) & -65536).view(torch.float32)
    return torch.stack([hi, mid, rest - mid], -1)


def weight_fragments(w3: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
                     ) -> torch.Tensor:
    """The bf16 kernel's weights: the (channel, k) matrix of the BN-folded
    6x6 kernel (`rearrange_weight`) rounded to bf16 at k < 108, in
    (ky, kx, c) tap order, and `shift_parts(shift)` at k = 108..110 (the
    kernel's X is 1 there, so the products add the shift in fp32), zero at
    k = 111 and in the channels padded to a multiple of CHUNK; cut into the
    A fragments of mma.sync.m16n8k16 (row-major A) in the order the
    kernel's lanes load them.

    Returns (O_pad / 32, 7, 2, 32, 4, 2) bf16: (channel chunk, k-step s,
    m16 tile mt, lane, register r, half). Lane 4 gid + tid holds in
    register r = rh + 2 kh channel 32 chunk + 16 mt + gid + 8 rh at k =
    16 s + 8 kh + 2 tid (low half) and that + 1 (high half)."""
    O = w3.shape[0]
    w6 = rearrange_weight(w3.to(torch.float32), scale.to(torch.float32))
    wm = torch.cat([w6.permute(0, 2, 3, 1).reshape(O, TAPS), shift_parts(shift)], 1)
    wm = F.pad(wm, (0, MMA_K - TAPS - 3, 0, -O % CHUNK)).to(torch.bfloat16)
    # (chunk, mt, rh, gid, s, kh, tid, half) -> (chunk, s, mt, gid, tid, kh, rh, half)
    wm = wm.reshape(-1, 2, 2, 8, MMA_K // 16, 2, 4, 2).permute(0, 4, 1, 3, 6, 5, 2, 7)
    return wm.reshape(-1, MMA_K // 16, 2, 32, 4, 2).contiguous()


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(F, C, H, W) -> (F, 4C, H/2, W/2) in the reference's channel order
    (top-left, bottom-left, top-right, bottom-right; network_blocks.py:274)."""
    return torch.cat([x[..., 0::2, 0::2], x[..., 1::2, 0::2],
                      x[..., 0::2, 1::2], x[..., 1::2, 1::2]], 1)


def focus_stem_plain(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, out_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Plain PyTorch version. x (F, H, W, 3) NHWC (fp32 or uint8); w3
    (O, 12, 3, 3); scale/shift (O,). Returns (F, O, H/2, W/2) in
    `out_dtype`, contiguous (NCHW) like the kernel's output.

    fp32: in the Focus module's own terms, s2d, the 3x3 conv, folded BN,
    SiLU. bf16: what the Pallas kernel computes (focus_stem.py:144-148,
    161, 195), the image and the BN-folded 6x6 weights rounded to bf16,
    the 6x6 stride-2 conv summed in fp32, + shift and SiLU in fp32, the
    result rounded to bf16."""
    f32 = torch.float32
    if out_dtype == f32:
        xs = space_to_depth(x.permute(0, 3, 1, 2).to(f32).contiguous())
        y = F.conv2d(xs, w3.to(f32), padding=w3.shape[-1] // 2)
        y = y * scale[None, :, None, None] + shift[None, :, None, None]
        return F.silu(y)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"focus_stem writes fp32 or bf16, not {out_dtype}")
    bf = lambda t: t.to(torch.bfloat16).to(f32)
    xn = bf(x.permute(0, 3, 1, 2)).contiguous()
    w6 = bf(rearrange_weight(w3.to(f32), scale.to(f32)))
    y = F.conv2d(xn, w6, stride=2, padding=2) + shift.to(f32)[None, :, None, None]
    return F.silu(y).to(out_dtype)


def focus_stem_reference(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """The stem's math as JAX's backward recomputes it (`_xla_reference`,
    focus_stem.py:110, fp32 compute): the 6x6/s2 conv of the fp32 image
    with the BN-scaled weights, + shift, SiLU as y sigmoid(y); (F, O, H/2,
    W/2) fp32."""
    f32 = torch.float32
    w6 = rearrange_weight(w3.to(f32), scale.to(f32))
    y = F.conv2d(x.permute(0, 3, 1, 2).to(f32), w6, stride=2, padding=2)
    y = y + shift.to(f32)[None, :, None, None]
    return y * torch.sigmoid(y)


def focus_stem(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, out_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Fused eval stem. Arguments as in `focus_stem_plain`. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel of
    `out_dtype` (fp32: `focus_stem_kernel`, bf16: `focus_stem_mma`), which
    writes the (F, O, H/2, W/2) result contiguous (NCHW), the memory
    format of the plain version and of every conv after the stem. The
    bf16 kernel reads uint8 frames as they are; other frames are read as
    fp32.

    The launch is the op `tscd::focus_stem` (fp32) or
    `tscd::focus_stem_bf16` (`ops.py`), which a traced or exported graph
    holds. Differentiable in x (a floating image), w3, scale and shift
    through `_Differentiable`, with JAX's backward rule, where an input
    needs a gradient and grad mode is on; otherwise the op is called
    directly, and autograd records nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w3, scale, shift)):
        return _Differentiable.apply(x, w3, scale, shift, out_dtype)
    return _forward(x, w3, scale, shift, out_dtype)


class _Differentiable(torch.autograd.Function):
    """The stem with JAX's `_fwd`/`_bwd` (focus_stem.py:207-221): the
    forward is the kernel (the plain version on the CPU) and keeps its
    inputs; the backward differentiates `focus_stem_reference` on them
    under the upstream gradient cast to fp32 (the VJP of the reference's
    cast to `out_dtype`). Each backward adds one to
    `focus_stem.backward_calls`; its work runs in a profiler range of
    that name."""

    @staticmethod
    def forward(ctx, x, w3, scale, shift, out_dtype):
        ctx.save_for_backward(x, w3, scale, shift)
        return _forward(x, w3, scale, shift, out_dtype)

    @staticmethod
    def backward(ctx, g):
        focus_stem.backward_calls += 1
        ins = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
            out = focus_stem_reference(*ins)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g.to(torch.float32)))
        return (*(next(grads) if n else None for n in need), None)


def _forward(x, w3, scale, shift, out_dtype):
    """The op of `out_dtype` (`ops.py`: tscd::focus_stem, fp32, or
    tscd::focus_stem_bf16): on a CPU tensor the plain version, on a CUDA
    tensor the launch."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"focus_stem: unsupported device {x.device}")
    if out_dtype == torch.float32:
        return torch.ops.tscd.focus_stem(x, w3, scale, shift)
    if out_dtype == torch.bfloat16:
        return torch.ops.tscd.focus_stem_bf16(x, w3, scale, shift)
    raise ValueError(f"focus_stem writes fp32 or bf16, not {out_dtype}")


def launch(x, w3, scale, shift, out_dtype):
    """One launch of the kernel of `out_dtype` on CUDA tensors (the ops'
    CUDA implementation)."""
    Fr, H, W, C = x.shape
    O = w3.shape[0]
    if C != 3 or w3.shape != (O, 4 * C, 3, 3):
        raise ValueError(f"focus_stem takes (F, H, W, 3) and (O, 12, 3, 3), "
                         f"got {tuple(x.shape)} and {tuple(w3.shape)}")
    if H % 2 or W % 2 or O % 8:
        raise ValueError("focus_stem needs even H, W and O a multiple of 8")
    out = torch.empty(Fr, O, H // 2, W // 2, device=x.device, dtype=out_dtype)
    lib = library.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if out_dtype == torch.bfloat16:
            u8 = x.dtype == torch.uint8
            xin = x.contiguous() if u8 else x.to(torch.float32).contiguous()
            wf = weight_fragments(w3, scale, shift)
            rc = lib.tscd_focus_stem_bf16(xin.data_ptr(), wf.data_ptr(), out.data_ptr(), Fr, H,
                                          W, C, O, int(u8), stream)
        else:
            xin = x.to(torch.float32).contiguous()
            wk = rearrange_weight(w3.to(torch.float32), scale.to(torch.float32))
            wk = wk.permute(2, 3, 1, 0).contiguous()           # (ky, kx, c, o)
            sh = shift.to(torch.float32).contiguous()
            rc = lib.tscd_focus_stem(xin.data_ptr(), wk.data_ptr(), sh.data_ptr(),
                                     out.data_ptr(), Fr, H, W, C, O, stream)
    library.check(lib, rc, "focus_stem")
    focus_stem.launches += 1
    return out


focus_stem.launches = 0
focus_stem.backward_calls = 0
