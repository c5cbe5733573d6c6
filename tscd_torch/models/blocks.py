"""Conv primitives of the detection core (counterpart of
tscd_tpu/models/blocks.py; reference network_blocks.py). NCHW,
BatchNorm with eps 1e-5.

BatchNorm mode, as the JAX modules' `train` argument: each forward takes
`stats`, None for eval-mode BN (the running statistics), or a dict for
train-mode BN (`batch_norm`): the batch's statistics normalise, and the
new running statistics are put in `stats` under the BatchNorm module,
not written into its buffers, so that a step over several windows can
average them (tscd_tpu/core/tscd_trainer.py:198-214). Modules stay in
torch's eval mode either way.

Compute dtype (`dtype`, fp32 or bf16), as the JAX modules' `dtype`
field: the conv weights are stored in it (cast once, at construction or
on load) and the conv and the activation run in it; BatchNorm keeps fp32
parameters and runs in fp32 on the conv's output, which is then cast
back (blocks.py:231-245). `utils.model_utils.fuse_model` folds the BN
into the conv: the conv then has a bias and `bn` is None (JAX:
`use_bias`).

int8 (w8a8) serving, as JAX's (blocks.py:32-200, 248-353): inside
`int8_eval()` a BaseConv with eval-mode BN (`stats` None), groups 1,
C_in >= the mode's threshold and a path in the mode's scope (where one is
given) runs the hand int8 conv
(`ops.kernels.int8_conv`): BN folded into the weights, int8 weights with
one scale an output channel, int8 activations with one scale over the
whole batch (dynamic: max |x| / 127 a call) or calibrated (static: per
input channel maxima recorded by `quantize_int8` / `quantize_int8_scan`
under `int8_eval(calibrate=True)`, half their spread moved into the
weights), int32 sums, then dequant, bias and the activation. The weights
are prepared once by `utils.model_utils.prepare_int8` (from fp32 weights)
and kept on each BaseConv outside its state_dict; a model in int8 mode
without it raises. The training knobs: `int8_eval(scope=...)` (a frozen
int8 backbone under a trained fp head) and `int8_eval(qat=True)` (the STE
conv on the live weights, `BaseConv._qat_forward`)."""

import contextlib
import contextvars
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import int8_conv as q8
from ..ops.kernels.focus_stem import focus_stem, rearrange_weight

# new running statistics of a train-mode forward: {BatchNorm module:
# (running mean, running var)}
BNStats = Dict[nn.BatchNorm2d, Tuple[torch.Tensor, torch.Tensor]]


def batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor,
               stats: Optional[BNStats]) -> torch.Tensor:
    """BatchNorm of y (N, C, H, W) in fp32, cast back to y's dtype. With
    `stats` None, eval mode (the running statistics). Otherwise flax's
    train mode (nn.BatchNorm, flax 0.12.3 normalization.py): the batch
    mean and the biased variance E[x^2] - E[x]^2 (its fast variance,
    floored at 0) normalise, (x - mean) * (rsqrt(var + eps) * scale) +
    bias, and stats[bn] gets running averages of them, which carry no
    gradient: flax's momentum is 1 - `bn.momentum` (torch's default 0.1 is
    flax's 0.9; the ELAN family's 0.03 is its 0.97), running = m running +
    (1 - m) batch."""
    x = y.float()
    if stats is None:
        return bn(x).to(y.dtype)
    axes = (0, 2, 3)
    mean = x.mean(axes)
    var = ((x * x).mean(axes) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    out = (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    m = 1.0 - bn.momentum
    stats[bn] = (m * bn.running_mean + (1.0 - m) * mean.detach(),
                 m * bn.running_var + (1.0 - m) * var.detach())
    return out.to(y.dtype)


def batch_stats(model: nn.Module, stats: BNStats) -> Dict[str, torch.Tensor]:
    """A train-mode forward's new running statistics under the state_dict
    keys of their BatchNorm modules."""
    return {f"{name}.running_{k}": v for name, bn in model.named_modules()
            if bn in stats for k, v in zip(("mean", "var"), stats[bn])}


def run(seq: nn.Sequential, x: torch.Tensor,
        stats: Optional[BNStats]) -> torch.Tensor:
    """The modules of `seq` in turn, each given the BN mode `stats`."""
    for m in seq:
        x = m(x, stats)
    return x


# --- int8 (w8a8) serving mode ------------------------------------------
# The mode lives in one ContextVar holding an immutable tuple, as JAX's
# (blocks.py:46-63): concurrent threads each see their own context's mode.
# JAX reads it when it traces; the port runs eagerly and reads it at each
# forward, so a CUDA graph captured in one mode must not replay in another
# (`int8_graph_key`, which core/predict.py puts in its graphs' keys).
class Int8Mode(NamedTuple):
    enable: bool = False
    static: bool = False
    calibrate: bool = False
    scope: Optional[Tuple[Tuple[str, ...], ...]] = None
    qat: bool = False


_INT8_MODE: "contextvars.ContextVar[Int8Mode]" = contextvars.ContextVar(
    "tscd_int8_mode", default=Int8Mode())

# Only convs with C_in >= this quantize (JAX's gates and their defaults,
# blocks.py:64-80): dynamic scales pay a max pass a call, static ones do not.
INT8_MIN_CIN = 128
INT8_MIN_CIN_STATIC = 32

def int8_mode() -> Int8Mode:
    return _INT8_MODE.get()


def _int8_min_cin() -> int:
    # calibration must cover every layer the static mode will use
    mode = _INT8_MODE.get()
    return INT8_MIN_CIN_STATIC if (mode.static or mode.calibrate) else INT8_MIN_CIN


def int8_eval_enabled() -> bool:
    return _INT8_MODE.get().enable


def set_int8_eval(enable: bool) -> None:
    """Sticky (non-scoped) toggle for CLI tools; affects only the current
    thread/context (the mode is a ContextVar)."""
    _INT8_MODE.set(_INT8_MODE.get()._replace(enable=bool(enable)))


@contextlib.contextmanager
def int8_eval(enable: bool = True, static: bool = False, calibrate: bool = False,
              scope=None, qat: bool = False):
    """int8 mode for the forwards inside the block. `calibrate=True`
    records each quantizing conv's per-input-channel maxima of its fp
    activations (`quantize_int8`); `static=True` serves with them. `scope`
    (module-path prefixes, each a tuple of name components, e.g.
    (("backbone",),) for a frozen-backbone train step) quantizes only the
    BaseConvs under one of them (`stamp_int8_paths` names them). `qat=True`
    runs the eligible convs as the differentiable STE conv
    (`ops.kernels.int8_conv.int8_conv_ste`) on the live weights, so a
    fix_bn train step fine-tunes against the int8 noise."""
    token = _INT8_MODE.set(Int8Mode(
        enable=bool(enable), static=bool(static), calibrate=bool(calibrate),
        scope=tuple(tuple(p) for p in scope) if scope is not None else None,
        qat=bool(qat)))
    try:
        yield
    finally:
        _INT8_MODE.reset(token)


def stamp_int8_paths(model: nn.Module) -> nn.Module:
    """Gives every BaseConv of `model` its path, the components of its
    dotted name in `model` (("backbone", "backbone", "dark2", ...)), which
    `int8_eval(scope=...)` matches against, as JAX's `_int8_in_scope`
    matches a flax module's path: flax's ("backbone",) is the port's
    `backbone...` (the YOLOPAFPN, its CSPDarknet and its FPN convs). Done
    once, by `utils.model_utils.prepare_int8` and the trainers; the
    forward only reads it."""
    for name, m in model.named_modules():
        if isinstance(m, BaseConv):
            m._int8_path = tuple(name.split(".")) if name else ()
    return model


def in_int8_scope(path: Optional[Tuple[str, ...]],
                  scope: Optional[Tuple[Tuple[str, ...], ...]]) -> bool:
    """Whether a conv at `path` lies under one of `scope`'s prefixes, whole
    components matched (blocks.py:136-141); every conv where scope is
    None."""
    return scope is None or any(path[:len(p)] == p for p in scope)


def int8_graph_key(model: nn.Module) -> Optional[tuple]:
    """What a captured forward of `model` depends on beyond its inputs'
    shapes: None in fp, else the mode and the identity of the model's int8
    preparation (weights and scales, `prepare_int8`). A graph captured
    under one key must replay under that key only."""
    mode = _INT8_MODE.get()
    if not mode.enable:
        return None
    return (mode.static, mode.calibrate, mode.scope, mode.qat,
            getattr(model, "_int8_token", None))


def _int8_convs(model: nn.Module):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, BaseConv) and getattr(m, "_int8", None) is not None]


def quantize_int8(model: nn.Module, *sample_args, **kwargs) -> Dict[str, torch.Tensor]:
    """Calibrate static int8 activation scales (JAX's quantize_int8,
    blocks.py:132-140): `model(*sample_args, **kwargs)` under
    `int8_eval(calibrate=True)`. Returns {BaseConv name: act_scale (C_in,)},
    each max |x| / 127 per input channel of that conv's fp activations;
    serve with `utils.model_utils.set_int8_scales(model, scales)` and
    `int8_eval(static=True)`."""
    return quantize_int8_scan(model, [sample_args], **kwargs)


def quantize_int8_scan(model: nn.Module, chunks: Iterable[Sequence],
                       fn: Optional[Callable] = None, **kwargs) -> Dict[str, torch.Tensor]:
    """Calibration over several windows or frame chunks (JAX's
    quantize_int8_scan, blocks.py:143-200): `fn(*chunk, **kwargs)` (default
    the model) for each chunk under `int8_eval(calibrate=True)`, the
    per-conv maxima max-folded across chunks. Each chunk runs as given (a
    window from the initial matcher state, as JAX's scan body). The
    calibrate forward observes the fp activations, so a chunked fold equals
    a one-shot calibration exactly. Returns the scales as `quantize_int8`."""
    convs = _int8_convs(model)
    if not convs:
        raise ValueError("quantize_int8 needs the int8 weights: run "
                         "utils.model_utils.prepare_int8(model, ...) first")
    for _, m in convs:
        m._int8.act_scale = None
    run = fn or model
    with int8_eval(calibrate=True), torch.no_grad():
        for chunk in chunks:
            run(*chunk, **kwargs)
    return {n: m._int8.act_scale for n, m in convs if m._int8.act_scale is not None}


def get_activation(name: str = "silu") -> nn.Module:
    if name in ("silu", "swish"):
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    if name in ("id", "identity", None):
        return nn.Identity()
    raise ValueError(f"Unsupported act type: {name}")


class BaseConv(nn.Module):
    """Conv2d -> BatchNorm -> activation, 'same' padding for odd kernels;
    `valid=True` runs the same parameters with no padding (the sparse
    tower path's patch convs, blocks.py:216-221)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, groups: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              padding=(ksize - 1) // 2, groups=groups,
                              bias=False, dtype=dtype)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = get_activation(act)
        self.act_name = {"swish": "silu", "identity": "id", None: "id"}.get(act, act)
        self._int8 = None       # Int8Weights, from utils.model_utils.prepare_int8
        self._int8_path = None  # its name's components, from stamp_int8_paths

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None,
                valid: bool = False) -> torch.Tensor:
        c = self.conv
        if (stats is None and c.groups == 1 and _INT8_MODE.get().enable
                and x.shape[1] >= _int8_min_cin() and self._in_scope()):
            return self._int8_forward(x, 0 if valid else c.padding[0])
        y = (F.conv2d(x, c.weight, c.bias, c.stride, 0, c.dilation, c.groups)
             if valid else c(x))
        if self.bn is not None:
            y = batch_norm(self.bn, y, stats)
        return self.act(y)

    def _in_scope(self) -> bool:
        scope = _INT8_MODE.get().scope
        if scope is None:
            return True
        if self._int8_path is None:
            raise ValueError("int8_eval(scope=...) needs each BaseConv's path: run "
                             "models.blocks.stamp_int8_paths(model) (prepare_int8 does)")
        return in_int8_scope(self._int8_path, scope)

    def _int8_forward(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """The w8a8 route (blocks.py:248-353): calibrate (the fp32 BN-folded
        conv, recording max |x| / 127 per input channel), QAT (the STE conv
        on the live weights, `_qat_forward`), dynamic (one scale over the
        whole batch, formed on the device) or static (the calibrated
        x_scale and the weights that absorbed its spread)."""
        mode = _INT8_MODE.get()
        if mode.qat and not mode.calibrate:
            return self._qat_forward(x, pad)
        q = self._int8
        if q is None:
            raise ValueError("int8_eval needs the int8 weights: run "
                             "utils.model_utils.prepare_int8(model, state_dict) first")
        dtype = self.conv.weight.dtype
        stride = self.conv.stride[0]
        if mode.calibrate:
            xf = x.float()
            seen = q8.div127(xf.abs().amax((0, 2, 3)))
            q.act_scale = seen if q.act_scale is None else torch.maximum(q.act_scale, seen)
            # frame by frame: a conv's sums for one frame then never depend
            # on the others (oneDNN and cuDNN pick their algorithms by the
            # batch), so a chunked calibration equals a one-shot one exactly
            y = torch.cat([F.conv2d(xf[i:i + 1], q.w_eff, stride=stride, padding=pad)
                           for i in range(xf.shape[0])])
            y = y + q.b_eff[None, :, None, None]
            return self.act(y.to(dtype))
        if mode.static:
            if q.static is None:
                raise ValueError(
                    "int8_eval(static=True) needs calibrated activation scales: run "
                    "quantize_int8(model, *sample_batch) first and pass its scales to "
                    "utils.model_utils.set_int8_scales(model, scales)")
            wq, s_w, x_scale, s_t = q.static
            xq = q8.quantize_int8_activation(x.contiguous(), x_scale, "channel")
            return q8.int8_conv(xq, wq, s_w, q.b_eff, stride=stride, pad=pad,
                                act=self.act_name, out_dtype=dtype, s_x=s_t)
        wq, s_w = q.dynamic
        x = x.contiguous()
        amax = q8.abs_max(x)
        xq = q8.quantize_int8_activation(x, amax, "dynamic")
        return q8.int8_conv(xq, wq, s_w, q.b_eff, stride=stride, pad=pad,
                            act=self.act_name, out_dtype=dtype, amax=amax)

    def _qat_forward(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """QAT (blocks.py:322-339): BN folded from the live parameters at
        every call, with autograd (w_eff = w gamma / sqrt(var + 1e-5), b_eff
        = beta - mean s), so the gradients reach conv.weight, bn.weight and
        bn.bias; then the STE conv with dynamic scales
        (`q8.int8_conv_ste`). A prepared `Int8Weights` would be stale after
        one step, so QAT never reads it. At bf16 the live conv weight is
        the bf16 rounding of its fp32 master."""
        if _INT8_MODE.get().static:
            raise NotImplementedError("int8_eval(qat=True) runs dynamic scales; static "
                                      "QAT scales are not ported")
        c, bn = self.conv, self.bn
        w = c.weight.float()
        if bn is not None:
            s = bn.weight / torch.sqrt(bn.running_var + 1e-5)
            w_eff = w * s[:, None, None, None]
            b_eff = bn.bias - bn.running_mean * s
        else:
            w_eff = w
            b_eff = (c.bias.float() if c.bias is not None
                     else torch.zeros(w.shape[0], dtype=torch.float32, device=w.device))
        return q8.int8_conv_ste(x, w_eff, b_eff, stride=c.stride[0], pad=pad,
                                act=self.act_name, out_dtype=c.weight.dtype)


class Int8Weights:
    """A BaseConv's int8 preparation (`utils.model_utils.prepare_int8`),
    kept outside its state_dict: the BN-folded fp32 weight and bias, the
    dynamic route's packed int8 weights and scales (wq, s_w), the static
    route's (wq, s_w, x_scale, s_t) where scales were given, and the
    calibration record `act_scale`."""

    def __init__(self, w_eff: torch.Tensor, b_eff: torch.Tensor):
        self.w_eff, self.b_eff = w_eff, b_eff
        self.dynamic = pack_weights(w_eff)
        self.static: Optional[Tuple[torch.Tensor, ...]] = None
        self.act_scale: Optional[torch.Tensor] = None

    def set_scales(self, act_scale: torch.Tensor) -> None:
        """The static route's quantities from calibrated maxima
        (blocks.py:290-304): e_c = sqrt(s_c / geometric mean), clipped to
        [1/16, 16], s_t = max(s_c / e_c), x_scale = e_c s_t, weights w_eff
        e_c (s_w taken after that)."""
        s_c = torch.clamp_min(act_scale.to(self.w_eff.device, torch.float32), 1e-8)
        e_c = torch.sqrt(s_c / torch.exp(torch.mean(torch.log(s_c))))
        e_c = torch.clamp(e_c, 1.0 / 16, 16.0)
        s_t = torch.amax(s_c / e_c).reshape(1)
        wq, s_w = pack_weights(self.w_eff * e_c[None, :, None, None])
        self.static = (wq, s_w, (e_c * s_t).contiguous(), s_t)


def pack_weights(w_eff: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed int8 weights, s_w): s_w = max(max |w| over (C, k, k), 1e-8) /
    127 per output channel (blocks.py:308-309), the weights round(w / s_w)
    in the conv kernel's layout."""
    s_w = q8.weight_scale(w_eff)
    return q8.pack_int8_weight(w_eff.contiguous(), s_w), s_w


class DWConv(nn.Module):
    """Depthwise conv followed by pointwise conv (network_blocks.py:64)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride,
                              groups=in_channels, act=act, dtype=dtype)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act=act,
                              dtype=dtype)

    def forward(self, x: torch.Tensor, stats: Optional[BNStats] = None,
                valid: bool = False) -> torch.Tensor:
        return self.pconv(self.dconv(x, stats, valid), stats)


def conv_cls(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """Standard bottleneck (network_blocks.py:158)."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv2 = conv_cls(depthwise)(hidden, out_channels, 3, 1, act=act,
                                         dtype=dtype)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        y = self.conv2(self.conv1(x, stats), stats)
        return y + x if self.use_add else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (network_blocks.py:201)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.m = nn.ModuleList(
            nn.MaxPool2d(ks, stride=1, padding=ks // 2) for ks in kernel_sizes)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels,
                              1, 1, act=act, dtype=dtype)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        x = self.conv1(x, stats)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], 1), stats)


class ResLayer(nn.Module):
    """Residual 1x1 -> 3x3 lrelu layer (network_blocks.py:183)."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels // 2
        self.layer1 = BaseConv(in_channels, mid, 1, 1, act="lrelu", dtype=dtype)
        self.layer2 = BaseConv(mid, in_channels, 3, 1, act="lrelu", dtype=dtype)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        return x + self.layer2(self.layer1(x, stats), stats)


class ConvBN(nn.Sequential):
    """1x1 conv then BatchNorm, no activation: the reference's ResNet
    `downsample`, an nn.Sequential (names `0` and `1`); JAX runs it as a
    BaseConv with act "id" (blocks.py:650-652)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Conv2d(in_channels, out_channels, 1, stride, bias=False,
                                   dtype=dtype),
                         nn.BatchNorm2d(out_channels, eps=1e-5))

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        return batch_norm(self[1], self[0](x), stats)


class ResNetBottleneck(nn.Module):
    """Bottleneck with the stride on the 3x3 (network_blocks.py:292). As
    the reference, ConvBn3 applies the activation before the residual
    add, and the activation runs once more after it."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, groups: int = 1, base_width: int = 64,
                 act: str = "relu", expansion: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * expansion
        self.ConvBn1 = BaseConv(in_channels, width, 1, 1, groups, act=act, dtype=dtype)
        self.ConvBn2 = BaseConv(width, width, 3, stride, groups, act=act, dtype=dtype)
        self.ConvBn3 = BaseConv(width, out, 1, 1, groups, act=act, dtype=dtype)
        self.downsample = ConvBN(in_channels, out, stride, dtype) if has_downsample else None
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        y = self.ConvBn3(self.ConvBn2(self.ConvBn1(x, stats), stats), stats)
        identity = x if self.downsample is None else self.downsample(x, stats)
        return self.act(y + identity)


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convolutions (network_blocks.py:226)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act=act, dtype=dtype)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act=act,
                              dtype=dtype)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act,
                       dtype=dtype)
            for _ in range(n)])

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        x1 = run(self.m, self.conv1(x, stats), stats)
        x2 = self.conv2(x, stats)
        return self.conv3(torch.cat([x1, x2], 1), stats)


class Focus(nn.Module):
    """Space-to-depth stem (network_blocks.py:267).

    Takes the raw (F, H, W, 3) image (fp32, or uint8 at bf16). With
    eval-mode BN, BN folds into scale/shift as in blocks.py:580-598; with
    ksize 3, stride 1 and SiLU the stem (6x6/s2 conv + shift + SiLU) runs
    as the hand kernel `ops.kernels.focus_stem`, differentiable in the
    weights and BN parameters (its backward is JAX's `_bwd`, a plain
    recompute); its plain version does s2d + the 3x3 conv. Any other
    ksize, stride or activation takes JAX's own route for it, where no
    Pallas kernel runs either (blocks.py:596-598): the (2k)x(2k)/(2s) conv
    in the compute dtype, then scale and shift in fp32, then the
    activation. With train-mode BN (`stats` given) JAX's Focus runs that
    conv, then BatchNorm, then the activation (blocks.py:573-577), and so
    does this one, with no kernel launch. The parameters are the
    reference's (`stem.conv.conv.weight` (O, 4C, k, k), `stem.conv.bn.*`)
    and stay fp32 at any compute dtype: at bf16 the kernel rounds the
    BN-folded weights to bf16 itself and writes bf16, as the Pallas kernel
    does (focus_stem.py:144-148), and the XLA-route conv casts the image
    and the (2k)x(2k) weights to bf16, as `_conv6` does. After
    `fuse_model` the conv's bias is the shift and the scale is 1."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if ksize % 2 != 1:
            raise ValueError("the Focus stem's fused conv takes an odd ksize")
        self.dtype = dtype
        self.ksize, self.stride = ksize, stride
        self.kernel = (ksize, stride, act) == (3, 1, "silu")
        self.conv = BaseConv(in_channels * 4, out_channels, ksize, stride,
                             act=act)

    def _conv6(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's `_conv6`: the s2d + kxk conv as one (2k)x(2k) conv of
        stride 2s over the NHWC image, in the compute dtype."""
        w6 = rearrange_weight(self.conv.conv.weight).to(self.dtype)
        return F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), w6,
                        stride=2 * self.stride, padding=self.ksize - 1)

    def forward(self, x: torch.Tensor,
                stats: Optional[BNStats] = None) -> torch.Tensor:
        conv, bn = self.conv.conv, self.conv.bn
        if stats is not None:
            if bn is None:
                raise ValueError("train-mode BatchNorm on a model with BN folded")
            return self.conv.act(batch_norm(bn, self._conv6(x), stats))
        if bn is None:
            shift = conv.bias
            scale = torch.ones_like(shift)
        else:
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
        if self.kernel:
            return focus_stem(x, conv.weight, scale, shift, out_dtype=self.dtype)
        y = self._conv6(x).float() * scale[:, None, None] + shift[:, None, None]
        return self.conv.act(y.to(self.dtype))
