"""int8 (w8a8) convolution of the int8 serving mode (a port kernel with no
Pallas counterpart).

Replaces the XLA int8 conv of tscd_tpu/models/blocks.py:347-353
(BaseConv._int8_forward): PyTorch has no int8 convolution on CUDA. CUDA
source: tscd_torch/csrc/int8_conv.cu. Four wrappers, each counting its
launches in `.launches`:

  abs_max(x)                            max |x| over the whole tensor, (1,) fp32
  quantize_int8_activation(x, scale, mode)
                                        NCHW fp32/bf16 -> NHWC int8, C padded
                                        to 32: clip(round(x / s), -127, 127)
  pack_int8_weight(w_eff, s_w)          (N, C, k, k) fp32 -> (N, k, k, Cp) int8,
                                        round(w / s_w[n]) (a launch of the
                                        quantize kernel, one scale a row)
  int8_conv(xq, wq, s_w, bias, ...)     the implicit-GEMM conv on the int8
                                        tensor cores, int32 sums, then the
                                        epilogue act(cast(float(acc) * (s_x *
                                        s_w) + b)), NCHW in the model's dtype;
                                        `out_int32=True` gives the sums

The dynamic scale stays on the device: `int8_conv` and the quantize pass
take the abs max itself (`amax=`) and form s_x = max(amax, 1e-8) / 127
there, so a dynamic conv reads nothing back to the host.

Each wrapper checks its arguments and calls its torch op (`ops.py`:
tscd::int8_absmax, tscd::int8_quantize, tscd::int8_conv), whose CUDA
implementation is the launcher (`launch_*`, which counts the launch) and
whose CPU implementation is the plain version. `int8_conv_ste` is the QAT
conv on these kernels, differentiable with JAX's straight-through
gradients (plain version `int8_conv_ste_reference`).

Beside them, the plain versions in the same arithmetic, which a CPU
tensor takes: `quantize_reference`, `pack_reference`,
`int8_conv_reference` (the int8 values as float64 through F.conv2d, cast
to int32: exact, since |sum| <= 2048 * 9 * 127^2 < 2^53) and
`epilogue_reference`. A CUDA tensor launches the kernel or raises.

Bound: the conv is operations-bound at the main path's shapes (1979 TOP/s
of int8 on the H100's tensor cores; a 1x1 conv at C_in 128 already does
256 operations a byte of its int8 input); the abs-max and quantize passes
are bytes-bound (3.35 TB/s).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from . import library

C_ALIGN = 32                    # the conv's k-step: channels pad to it
ACTIVATIONS = ("id", "silu", "relu", "lrelu")   # the kernel's codes 0-3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OUT_DTYPES = {v: k for k, v in _DTYPES.items()}   # the conv's output codes
OUT_INT32 = 2                                      # and the int32 sums'
MODES = {"dynamic": 0, "channel": 1, "row": 2}
MODE_NAMES = {v: k for k, v in MODES.items()}


def padded_channels(c: int) -> int:
    return -(-c // C_ALIGN) * C_ALIGN


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, a true division as JAX's: torch turns a division of a CUDA
    tensor by a Python number into a multiply by its reciprocal, which
    is an ulp off now and then."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def dynamic_scale(amax: torch.Tensor) -> torch.Tensor:
    """s_x = max(amax, 1e-8) / 127 in fp32 (blocks.py:305-306)."""
    return div127(torch.clamp_min(amax.float(), 1e-8))


def activation(y: torch.Tensor, act: str) -> torch.Tensor:
    """BaseConv's activation by name (`models.blocks.get_activation`)."""
    if act == "silu":
        return F.silu(y)
    if act == "relu":
        return F.relu(y)
    if act == "lrelu":
        return F.leaky_relu(y, 0.1)
    if act == "id":
        return y
    raise ValueError(f"the int8 conv takes activations {ACTIVATIONS}, got {act!r}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, what: str, msg: str):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_device(what: str, *ts: torch.Tensor):
    dev = ts[0].device
    _require(dev.type in ("cpu", "cuda"), what, f"unsupported device {dev}")
    for t in ts:
        _require(t.device == dev, what, f"tensors on {dev} and {t.device}")
        if dev.type == "cuda":
            _require(t.is_contiguous(), what, "takes contiguous tensors")


# ----------------------------------------------------------------- abs max

def abs_max(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor, a (1,) fp32 tensor on x's device (no
    host read), through the op `tscd::int8_absmax`. x fp32 or bf16."""
    _check_device("abs_max", x)
    _require(x.dtype in _DTYPES, "abs_max", f"takes fp32 or bf16, got {x.dtype}")
    _require(x.numel() > 0, "abs_max", "takes a non-empty tensor")
    return torch.ops.tscd.int8_absmax(x.detach())


def launch_absmax(x: torch.Tensor) -> torch.Tensor:
    """One launch of the abs-max kernel (the op's CUDA implementation)."""
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = library.load()
    with torch.cuda.device(x.device):
        rc = lib.tscd_int8_absmax(x.data_ptr(), x.numel(), _DTYPES[x.dtype], out.data_ptr(),
                                  _stream(x))
    library.check(lib, rc, "int8 abs max")
    abs_max.launches += 1
    return out


# ---------------------------------------------------------------- quantize

def _divisor(scale: torch.Tensor, mode: str, shape) -> torch.Tensor:
    """The quantize pass's divisor, broadcast over (F, C, H, W)."""
    if mode == "dynamic":
        return dynamic_scale(scale).reshape(1, 1, 1, 1)
    if mode == "channel":
        return scale.reshape(1, -1, 1, 1)
    return scale.reshape(-1, 1, 1, 1)


def quantize_reference(x: torch.Tensor, scale: torch.Tensor, mode: str,
                       clip: bool = True) -> torch.Tensor:
    """Plain version of the quantize pass: (F, C, H, W) -> (F, H, W, Cp)
    int8 of clip(round(x / s), -127, 127), in fp32 (x upcast first,
    blocks.py:273, 347-348), channels past C zero. `mode`: "dynamic"
    (scale is the abs max), "channel" (a (C,) divisor) or "row" (an (F,)
    divisor: weights, rounded with no clip, blocks.py:349)."""
    q = torch.round(x.float() / _divisor(scale.float(), mode, x.shape))
    if clip:
        q = q.clamp(-127, 127)
    q = q.to(torch.int8).permute(0, 2, 3, 1)
    C = x.shape[1]
    return F.pad(q, (0, padded_channels(C) - C)).contiguous()


def _check_quantize(x: torch.Tensor, scale: torch.Tensor, mode: str, what: str):
    _check_device(what, x, scale)
    _require(x.dim() == 4, what, f"takes (F, C, H, W), got {tuple(x.shape)}")
    _require(x.dtype in _DTYPES, what, f"takes fp32 or bf16, got {x.dtype}")
    _require(scale.dtype == torch.float32, what, f"takes an fp32 scale, got {scale.dtype}")
    want = {"dynamic": 1, "channel": x.shape[1], "row": x.shape[0]}[mode]
    _require(scale.shape == (want,), what, f"{mode} scale of shape ({want},), got "
             f"{tuple(scale.shape)}")


def launch_quantize(x: torch.Tensor, scale: torch.Tensor, mode: int) -> torch.Tensor:
    """One launch of the quantize kernel (the op's CUDA implementation),
    counted by `pack_int8_weight` for the weights' "row" mode and by
    `quantize_int8_activation` otherwise."""
    what = "pack_int8_weight" if mode == MODES["row"] else "quantize_int8_activation"
    Fn, C, H, W = x.shape
    _require(1 <= Fn <= 65535, what, f"takes 1 <= F <= 65535, got {Fn}")
    Cp = padded_channels(C)
    out = torch.empty(Fn, H, W, Cp, dtype=torch.int8, device=x.device)
    lib = library.load()
    with torch.cuda.device(x.device):
        rc = lib.tscd_int8_quantize(x.data_ptr(), _DTYPES[x.dtype], Fn, C, H, W, Cp,
                                    scale.data_ptr(), mode, out.data_ptr(), _stream(x))
    library.check(lib, rc, what)
    counter = pack_int8_weight if mode == MODES["row"] else quantize_int8_activation
    counter.launches += 1
    return out


def quantize_int8_activation(x: torch.Tensor, scale: torch.Tensor,
                             mode: str = "dynamic") -> torch.Tensor:
    """(F, C, H, W) fp32 or bf16 -> (F, H, W, Cp) int8, Cp = C rounded up
    to 32 (zero channels past C): clip(round(x / s), -127, 127), with s
    max(scale, 1e-8) / 127 for mode "dynamic" (scale the (1,) abs max) or
    scale[c] for mode "channel" (the static (C,) x_scale); the op
    `tscd::int8_quantize`."""
    _require(mode in ("dynamic", "channel"), "quantize_int8_activation",
             f"mode dynamic or channel, got {mode!r}")
    _check_quantize(x, scale, mode, "quantize_int8_activation")
    return torch.ops.tscd.int8_quantize(x.detach(), scale.detach(), MODES[mode])


def pack_reference(w: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight packing: round(w / s_w[n]), no clip,
    (N, C, k, k) -> (N, k, k, Cp) int8."""
    return quantize_reference(w, s_w, "row", clip=False)


def pack_int8_weight(w: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """BN-folded fp32 weights (N, C, k, k) and their per-output-channel
    scales (N,) -> the conv kernel's int8 layout (N, k, k, Cp), K in tap-
    major, channel-minor order, channels past C zero: round(w / s_w[n]).
    The quantize kernel's clip cannot bind here (|w| / s_w <= 127); the op
    `tscd::int8_quantize` in its "row" mode."""
    _require(w.dim() == 4 and w.shape[2] == w.shape[3], "pack_int8_weight",
             f"takes (N, C, k, k), got {tuple(w.shape)}")
    _require(w.dtype == torch.float32, "pack_int8_weight", f"takes fp32, got {w.dtype}")
    _check_quantize(w, s_w, "row", "pack_int8_weight")
    return torch.ops.tscd.int8_quantize(w.detach(), s_w.detach(), MODES["row"])


# -------------------------------------------------------------------- conv

def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def int8_conv_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                        pad: int) -> torch.Tensor:
    """Plain version of the conv's int32 sums: xq (F, H, W, Cp) and wq
    (N, k, k, Cp) int8 -> (F, N, Ho, Wo) int32, through F.conv2d in
    float64 (every partial sum is an integer below 2^53, so exact)."""
    x = xq.permute(0, 3, 1, 2).double()
    w = wq.permute(0, 3, 1, 2).double()
    return F.conv2d(x, w, stride=stride, padding=pad).round().to(torch.int32)


def epilogue_reference(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
                       bias: torch.Tensor, act: str, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the epilogue, in blocks.py:352-353's order: float(acc)
    x (s_x * s_w)[c] (the product formed first, in fp32), + bias[c], cast
    to `dtype`, the activation on that value."""
    scale = (s_x.float() * s_w.float())[None, :, None, None]
    y = acc.float() * scale + bias.float()[None, :, None, None]
    return activation(y.to(dtype), act)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor, bias: torch.Tensor, *,
              stride: int, pad: int, act: str, out_dtype: torch.dtype,
              amax: Optional[torch.Tensor] = None, s_x: Optional[torch.Tensor] = None,
              out_int32: bool = False) -> torch.Tensor:
    """The w8a8 conv: xq (F, H, W, Cp) int8 (`quantize_int8_activation`),
    wq (N, k, k, Cp) int8 (`pack_int8_weight`), s_w and bias (N,) fp32 ->
    (F, N, Ho, Wo) in `out_dtype` (fp32 or bf16): act(cast(float(sum) *
    (s_x * s_w) + bias)). The activation scale is given as the (1,) abs max
    (`amax`, dynamic: s_x = max(amax, 1e-8) / 127) or as s_x itself (`s_x`,
    static). `out_int32=True` returns the int32 sums instead."""
    what = "int8_conv"
    _require((amax is None) != (s_x is None), what, "takes one of amax and s_x")
    sx = amax if s_x is None else s_x
    _check_device(what, xq, wq, s_w, bias, sx)
    _require(xq.dim() == 4 and wq.dim() == 4, what,
             f"takes xq (F, H, W, Cp) and wq (N, k, k, Cp), got {tuple(xq.shape)}, "
             f"{tuple(wq.shape)}")
    _require(xq.dtype == torch.int8 and wq.dtype == torch.int8, what, "takes int8 operands")
    Fn, H, W, Cp = xq.shape
    N, k, k2, Cpw = wq.shape
    _require(k == k2 and k % 2 == 1, what, f"takes an odd square kernel, got {k} x {k2}")
    _require(Cp == Cpw and Cp % C_ALIGN == 0, what,
             f"channels of xq {Cp} and wq {Cpw} must agree and be a multiple of {C_ALIGN}")
    _require(stride >= 1 and pad >= 0, what, f"stride {stride}, pad {pad}")
    Ho, Wo = out_size(H, k, stride, pad), out_size(W, k, stride, pad)
    _require(Ho >= 1 and Wo >= 1, what, f"no output at {H} x {W}, k {k}, pad {pad}")
    _require(s_w.shape == (N,) and bias.shape == (N,) and sx.shape == (1,), what,
             "s_w and bias (N,), the activation scale (1,)")
    _require(s_w.dtype == bias.dtype == sx.dtype == torch.float32, what, "fp32 scales and bias")
    _require(out_dtype in _DTYPES, what, f"writes fp32 or bf16, got {out_dtype}")
    _require(act in ACTIVATIONS, what, f"takes activations {ACTIVATIONS}, got {act!r}")
    return torch.ops.tscd.int8_conv(xq, wq, s_w.detach(), bias.detach(), sx.detach(), stride,
                                    pad, s_x is not None, ACTIVATIONS.index(act),
                                    OUT_INT32 if out_int32 else _DTYPES[out_dtype])


def launch_conv(xq, wq, s_w, bias, sx, stride: int, pad: int, static_scale: bool, act: int,
                out_code: int) -> torch.Tensor:
    """One launch of the conv kernel (the op's CUDA implementation)."""
    Fn, H, W, Cp = xq.shape
    N, k = wq.shape[:2]
    Ho, Wo = out_size(H, k, stride, pad), out_size(W, k, stride, pad)
    out = torch.empty(Fn, N, Ho, Wo, dtype=torch.int32 if out_code == OUT_INT32
                      else OUT_DTYPES[out_code], device=xq.device)
    lib = library.load()
    with torch.cuda.device(xq.device):
        rc = lib.tscd_int8_conv(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), s_w.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), Fn, H, W, Cp, N, k, stride, pad,
                                int(static_scale), act, out_code, _stream(xq))
    library.check(lib, rc, "int8_conv")
    int8_conv.launches += 1
    return out


# ----------------------------------------------------- QAT: the STE conv

def weight_scale(w_eff: torch.Tensor) -> torch.Tensor:
    """s_w = max(max |w| over (C, k, k), 1e-8) / 127 per output channel
    (blocks.py:308-309)."""
    return div127(torch.clamp_min(w_eff.abs().amax((1, 2, 3)), 1e-8))


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """round() with an identity gradient (JAX's `_ste_round`)."""
    return v + (torch.round(v) - v).detach()


def _clip127(v: torch.Tensor) -> torch.Tensor:
    """clip(v, -127, 127) differentiated as `jnp.clip` is, min(max(v, -127),
    127): gradient 1 inside, 0 outside, and 0.5 on a bound itself, where
    max and min split a tie between their arguments (torch.maximum and
    torch.minimum do, as jnp's do; torch.clamp passes 1 there). The value
    that sets a dynamic scale always rounds onto a bound."""
    lim = torch.full((), 127.0, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, -lim), lim)


def int8_conv_ste_reference(x: torch.Tensor, w_eff: torch.Tensor, b_eff: torch.Tensor,
                            stride: int, pad: int, act: str,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the QAT conv (blocks.py:322-339), differentiable:
    x fake-quantized with the dynamic scale s_x = max(max |x|, 1e-8) / 127
    and w_eff with s_w (both scales carry no gradient), clip(ste_round(x /
    s_x), -127, 127) with JAX's mask, ste_round(w_eff / s_w), their float
    conv in fp32, x (s_x s_w) + b_eff, cast to `out_dtype`, the
    activation. x (F, C, H, W) fp32 or bf16, w_eff (N, C, k, k) and b_eff
    (N,) fp32."""
    xf = x.float()
    s_x = dynamic_scale(xf.detach().abs().amax())
    s_w = weight_scale(w_eff.detach())
    xq = _clip127(_ste_round(xf / s_x))
    wq = _ste_round(w_eff / s_w[:, None, None, None])
    y = F.conv2d(xq, wq, stride=stride, padding=pad)
    y = y * (s_x * s_w)[None, :, None, None] + b_eff[None, :, None, None]
    return activation(y.to(out_dtype), act)


def int8_conv_ste(x: torch.Tensor, w_eff: torch.Tensor, b_eff: torch.Tensor, *, stride: int,
                  pad: int, act: str, out_dtype: torch.dtype) -> torch.Tensor:
    """The QAT conv (JAX's `int8_eval(qat=True)`, blocks.py:322-339) on the
    int8 kernels, differentiable in x, w_eff and b_eff with JAX's
    straight-through gradients. Arguments as in `int8_conv_ste_reference`,
    which a CPU tensor takes; a CUDA tensor runs `_Int8ConvSTE`."""
    if x.device.type == "cpu":
        return int8_conv_ste_reference(x, w_eff, b_eff, stride, pad, act, out_dtype)
    _require(x.device.type == "cuda", "int8_conv_ste", f"unsupported device {x.device}")
    return _Int8ConvSTE.apply(x, w_eff, b_eff, stride, pad, act, out_dtype)


class _Int8ConvSTE(torch.autograd.Function):
    """Forward: the serving path's launches on the live weights, so the
    output is the dynamic int8 route's bit for bit (`abs_max`, the
    quantize pass, `pack_int8_weight` of w_eff, `int8_conv` with the
    activation in its epilogue): exact int32 sums, where JAX's fp32
    fake-quant conv is exact only below 2^24. It keeps the int8 operands
    (xq, wq: a quarter of x's fp32 bytes) and the scales.

    Backward, the STE gradients, with g the upstream gradient through the
    activation and gs = g (s_x s_w)[c]:
      dx = conv_input_grad(gs, wq) m / s_x, m = 0.5 where |xq| = 127 and 1
           elsewhere (jnp.clip's gradient; under a dynamic scale no value
           rounds past 127, so the mask's 0 never occurs),
      dw_eff = conv_weight_grad(xq, gs) / s_w,  db_eff = sum of g.
    The two products are cuDNN's conv VJPs on the int8 values as fp32, as
    JAX takes them from XLA's conv VJP. The activation stays in the
    kernel's epilogue, which keeps the forward the serving launch itself;
    its gradient needs the pre-activation, which the backward recomputes
    by one more `int8_conv` launch with the identity epilogue on the kept
    operands (bit-equal to the epilogue's own value before the
    activation), rather than keeping an fp32 pre-activation tensor across
    the step."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, stride, pad, act, out_dtype):
        x = x.contiguous()
        amax = abs_max(x)
        xq = quantize_int8_activation(x, amax, "dynamic")
        s_w = weight_scale(w_eff.detach())
        wq = pack_int8_weight(w_eff.detach().contiguous(), s_w)
        b = b_eff.detach().float().contiguous()
        ctx.save_for_backward(xq, wq, amax, s_w, b)
        ctx.conf = (stride, pad, act, out_dtype, tuple(x.shape), x.dtype, tuple(w_eff.shape))
        return int8_conv(xq, wq, s_w, b, stride=stride, pad=pad, act=act, out_dtype=out_dtype,
                         amax=amax)

    @staticmethod
    def backward(ctx, g):
        xq, wq, amax, s_w, b = ctx.saved_tensors
        stride, pad, act, out_dtype, xshape, xdtype, wshape = ctx.conf
        if act != "id":
            pre = int8_conv(xq, wq, s_w, b, stride=stride, pad=pad, act="id",
                            out_dtype=out_dtype, amax=amax)
            with torch.enable_grad():
                pre.requires_grad_(True)
                g = torch.autograd.grad(activation(pre, act), pre, g)[0]
        g = g.float()
        s_x = dynamic_scale(amax)
        gs = g * (s_x * s_w)[None, :, None, None]
        C = xshape[1]
        xf = xq[..., :C].permute(0, 3, 1, 2).float()
        wf = wq[..., :C].permute(0, 3, 1, 2).float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dxq = torch.nn.grad.conv2d_input(xshape, wf, gs, stride=stride, padding=pad)
            m = torch.where(xf.abs() == 127, 0.5, 1.0)
            dx = (dxq * m / s_x).to(xdtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xf, wshape, gs, stride=stride, padding=pad)
            dw = dw / s_w[:, None, None, None]
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db, None, None, None, None


abs_max.launches = 0
quantize_int8_activation.launches = 0
pack_int8_weight.launches = 0
int8_conv.launches = 0
