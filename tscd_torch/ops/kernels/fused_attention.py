"""Fused dual-branch proposal attention (kernel 1 of the port).

Replaces tscd_tpu/ops/pallas/fused_attention.py (`_fused_forward` ->
`_kernel`), the hot op of MCA aggregation (aggregation.py:110) and of the
YOLOV family's MSA. CUDA source: tscd_torch/csrc/fused_attention.cu. Per
head: L2-normalised q/k of both branches, lc = 25 q^c.k^c * score[k],
lr = 25 q^r.k^r * fg[k] (fg the online MSA's reg-branch guidance,
aggregation.py:125-126; ones where the caller passes none, the form JAX's
Pallas kernel computes), -1e9 on invalid keys, attn = (softmax(lc) +
softmax(lr)) / 2, and attn@Vc, attn@Vr. The kernel writes attn, which the
round-2 pooling reads.

Two routes, chosen by the query count alone (`route`):
  - split (q <= 128: MCA's cross form, q = P = 50 at TSCD-Large, k =
    1600): the keys split over blocks of KEY_CHUNK keys, the chunks'
    softmax statistics combined in a second launch; fp32 FMA. With so few
    query rows the split over keys is what fills the card, and the
    product rate does not bound it; its scratch grows as q x k x d.
  - stream (q > 128: the self-attention form, q = k = F x P: 960 at
    YOLOV-L's window and the online MSA's default bank, 8000 in an OVIS
    YOLOV++ training window, 16000 in its eval window): a block a tile of
    `stream_plan` query rows (16 a warp, both branches, the warps of a row
    group splitting each key tile), the keys streamed through shared
    memory twice in tiles of STREAM_TILE (the softmax
    statistics, then attn and its products); no scratch, so a launch
    needs the bytes of attn and the outputs (4.1 GB at h 4, q = k =
    16000).
A launch whose bytes (`launch_bytes`) exceed the card raises with the
shape and the bytes.

The streaming kernel runs both products on the tensor cores (mma.sync
m16n8k8 .tf32) in the 3xTF32 split: each fp32 operand is hi + lo, both
rounded to TF32 (10 mantissa bits, to nearest), and a product is lo.hi'
+ hi.lo' + hi.hi' in fp32 accumulators. That keeps about 2^-21 of each
product against fp32's 2^-24: modelled at q = k = 960, d 64, its outputs
sit 2.4e-6 from float64, as fp32 FMA's do (2.3e-6), where one TF32
product is 1.8e-3 off and misses the port's 1e-5
(tests/test_torch_port_attention_stream.py). Its
exponentials are exp2 with log2(e) folded into each key's factor; key
tiles (and value tiles) are copied by cp.async into a ring of 2 while the
tile before is multiplied; attn is written as 16-byte stores from the
registers where the two branches combine.

Bounds on an H100. MCA's main-path shape (B=1, h=4, q=50, k=1600, d=64):
8.0 MB moved (2.40 us at 3.35 TB/s) and 0.164 GFLOP of fp32 FMA (2.45 us
at 67 TFLOP/s), so operations bound it, by a hair. q = k = 16000, h 4, d
64: 5.24e11 flops as 3 TF32 products each, 3.18 ms at 495 TFLOP/s,
against 4.1 GB of attn (1.22 ms): the tensor cores bound it, and the
streaming design's recompute of the logits puts its own floor at 1.5x
that (4.77 ms).

q, k and v may be strided views, as the aggregation's heads are: the
kernel reads any layout whose last dimension is contiguous, in fp32 or
bf16 (the bf16 model's Linear outputs), and computes in fp32 either way,
as the Pallas kernel upcasts in its body (bf16 values are exact in TF32,
so their logits take one product). At bf16 q/k/v move half the bytes
(5.4 MB at the main path), and operations still bound it.
"""

import ctypes
from typing import Tuple

import torch

from . import library

NEG = -1e9
KEY_CHUNK = 32      # keys a block of the split launch owns (KC in the source)
STREAM_TILE = 32    # keys a tile the streaming launch streams (KT)
STREAM_MAX_ROWS = 128   # query rows of the streaming route's largest block (MAX_ROWS)
SPLIT_MAX_Q = 128   # the split route's most query rows
BACKWARD_RANGE = "fused_dual_attention backward"


def route(q: int) -> str:
    """The launch `q` query rows take: "split" up to SPLIT_MAX_Q (the MCA
    cross form, q = P, where the split over keys fills the card), else
    "stream" (the self-attention form, whose split scratch would grow as
    q x k x d)."""
    return "split" if q <= SPLIT_MAX_Q else "stream"


def stream_plan(B: int, h: int, q: int, d: int, sms: int) -> Tuple[int, int]:
    """The streaming route's block at this shape, (rows, key slices): a
    block is rows / 16 row groups of 16 query rows, each a warp a key slice
    (the slices take the key tile's n-tiles in turn). rows is the largest
    of 128 (32 past a head dim of 64, for shared memory), 64, 32, 16 whose
    blocks still cover 9 in 10 of the card's `sms` SMs (10 B h ceil(q /
    rows) >= 9 sms), else 16; key slices min(4, 128 / rows). The mirror of
    `stream_plan` in the CUDA source: (128, 1) at q = 8000 and 16000 (h 4),
    (32, 4) at YOLOV-L's 960 on an H100's 132 SMs (120 blocks of 8 warps)."""
    rows = 32 if -(-d // 4) * 4 > 64 else STREAM_MAX_ROWS
    while rows > 16 and 10 * -(-q // rows) * B * h < 9 * sms:
        rows //= 2
    return rows, min(4, STREAM_MAX_ROWS // rows)


def scratch_floats(B: int, h: int, q: int, k: int, d: int) -> int:
    """fp32 scratch of one launch. Split: per (batch, head, query row) the
    chunk statistics (4 a chunk), the four chunk-local value products (4 x
    d padded to a multiple of 4, a chunk) and exp(l - m) of both branches
    (2 a key). Stream: none (each row's statistics stay in registers)."""
    if route(q) == "stream":
        return 0
    nch = -(-k // KEY_CHUNK)
    dp = -(-d // 4) * 4
    return B * h * q * (4 * nch + 4 * nch * dp + 2 * k)


def launch_bytes(B: int, h: int, q: int, k: int, d: int) -> int:
    """Device bytes one launch allocates: its route's scratch, `attn` and
    the two outputs, fp32. Split at MCA's (1, 4, 50, 1600, 64): 14.3 MB;
    stream at YOLOV-L's (1, 4, 960, 960, 64): 16.7 MB, at
    ovis_v++_large_decoupleReg's (1, 4, 16000, 16000, 64): 4.1 GB."""
    return 4 * (scratch_floats(B, h, q, k, d) + B * h * q * k + 2 * B * h * q * d)


def _buffers(B: int, h: int, q: int, k: int, d: int, device: torch.device):
    """The launch's outputs and scratch (none for the streaming route) on
    `device`; raises with the shape
    and the bytes where the card cannot hold them (more than its memory,
    or an allocation that fails): there is no other route to fall back to."""
    need = launch_bytes(B, h, q, k, d)
    total = torch.cuda.get_device_properties(device).total_memory
    what = (f"fused_dual_attention at (B {B}, h {h}, q {q}, k {k}, d {d}) needs {need} "
            f"bytes of scratch and outputs")
    if need > total:
        raise ValueError(f"{what}, more than the card's {total} bytes")
    f32 = dict(device=device, dtype=torch.float32)
    try:
        out_c = torch.empty(B, h, q, d, **f32)
        out_r = torch.empty_like(out_c)
        attn = torch.empty(B, h, q, k, **f32)
        n = scratch_floats(B, h, q, k, d)
        scratch = torch.empty(n, **f32) if n else None
    except torch.cuda.OutOfMemoryError as e:
        raise ValueError(f"{what}, which the card cannot hold now") from e
    return out_c, out_r, attn, scratch


def _rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype` with a contiguous last dimension; a view that already
    is one passes as it is."""
    if t.dtype == dtype and t.stride(-1) == 1:
        return t
    return t.to(dtype).contiguous()


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def fused_dual_attention_plain(qc, kc, vc, qr, kr, vr, cls_score, key_valid,
                               scale: float = 25.0, fg_score=None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (dual_attention_reference with a batch axis,
    and the reg logits times `fg_score` where it is given, as JAX's XLA
    path, aggregation.py:125-126). q* (B, h, q, d); k*/v* (B, h, k, d);
    cls_score and fg_score (B, k); key_valid (B, k) bool. Returns out_cls,
    out_reg (B, h, q, d) and attn (B, h, q, k), all fp32."""
    f32 = torch.float32
    lc = torch.einsum("bhqd,bhkd->bhqk", _l2n(qc.to(f32)), _l2n(kc.to(f32))) * scale
    lr = torch.einsum("bhqd,bhkd->bhqk", _l2n(qr.to(f32)), _l2n(kr.to(f32))) * scale
    lc = lc * cls_score.to(f32)[:, None, None, :]
    if fg_score is not None:
        lr = lr * fg_score.to(f32)[:, None, None, :]
    neg = torch.where(key_valid, 0.0, NEG).to(f32)[:, None, None, :]
    attn = 0.5 * (torch.softmax(lc + neg, -1) + torch.softmax(lr + neg, -1))
    out_cls = torch.einsum("bhqk,bhkd->bhqd", attn, vc.to(f32))
    out_reg = torch.einsum("bhqk,bhkd->bhqd", attn, vr.to(f32))
    return out_cls, out_reg, attn


def fused_dual_attention(qc, kc, vc, qr, kr, vr, cls_score, key_valid,
                         scale: float = 25.0, fg_score=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shapes as in `fused_dual_attention_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel of its `route` (d <=
    128), which reads q/k/v as they are when all six are fp32 or all six
    bf16 (any other mix is copied to fp32 first). Outputs are fp32.

    Differentiable in q/k/v, as JAX's `custom_vjp` (fused_attention.py:
    71-106): the call goes through `_Differentiable`, whose forward is
    the launch (or, on the CPU, the plain version) and whose backward
    recomputes the plain math and returns its VJP, as `_fused_bwd_rule`
    differentiates `dual_attention_reference`. Where no input needs a
    gradient or grad mode is off, autograd records nothing. `cls_score`
    and `key_valid` (and `fg_score`) get no gradient (JAX returns zeros for
    them)."""
    return _Differentiable.apply(qc, kc, vc, qr, kr, vr, cls_score,
                                 key_valid, fg_score, scale)


def _forward(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale):
    if qc.device.type == "cpu":
        return fused_dual_attention_plain(qc, kc, vc, qr, kr, vr, cls_score,
                                          key_valid, scale, fg_score)
    if qc.device.type != "cuda":
        raise ValueError(f"fused_dual_attention: unsupported device {qc.device}")
    return _launch(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale)


class _Differentiable(torch.autograd.Function):
    """The attention with JAX's backward rule: the forward's q/k/v, score
    and mask are kept, and the backward differentiates the plain version
    on them (JAX runs the same VJP of its reference through XLA, outside
    any Pallas kernel). Each backward adds one to
    `fused_dual_attention.backward_calls`; its work runs in a profiler
    range of that name."""

    @staticmethod
    def forward(ctx, qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale):
        ctx.save_for_backward(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score)
        ctx.scale = scale
        return _forward(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale)

    @staticmethod
    def backward(ctx, g_cls, g_reg, g_attn):
        fused_dual_attention.backward_calls += 1
        *qkv, cls_score, key_valid, fg_score = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in qkv]
            outs = fused_dual_attention_plain(*qkv, cls_score, key_valid,
                                              ctx.scale, fg_score)
            grads = torch.autograd.grad(outs, qkv, (g_cls, g_reg, g_attn))
        return (*grads, None, None, None, None)


def _launch(qc, kc, vc, qr, kr, vr, cls_score, key_valid, fg_score, scale):
    """One launch of the kernel of the query count's `route` on CUDA
    tensors. It counts one launch, though the split route runs as two
    kernels."""
    B, h, q, d = qc.shape
    k = kc.shape[2]
    for t in (qc, qr):
        if t.shape != (B, h, q, d):
            raise ValueError(f"query shape {tuple(t.shape)} != {(B, h, q, d)}")
    for t in (kc, vc, kr, vr):
        if t.shape != (B, h, k, d):
            raise ValueError(f"key/value shape {tuple(t.shape)} != {(B, h, k, d)}")
    if any(t is not None and t.shape != (B, k) for t in (cls_score, key_valid, fg_score)):
        raise ValueError("cls_score / key_valid / fg_score must be (B, k)")
    if key_valid.dtype != torch.bool:
        raise TypeError("key_valid must be bool")
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} outside 1..128")
    qkv = (qc, kc, vc, qr, kr, vr)
    bf16 = all(t.dtype == torch.bfloat16 for t in qkv)
    qkv = [_rows(t, torch.bfloat16 if bf16 else torch.float32) for t in qkv]
    score = cls_score.to(torch.float32).contiguous()
    fg = None if fg_score is None else fg_score.to(torch.float32).contiguous()
    valid = key_valid.contiguous()
    if any(t.device != qc.device for t in qkv + [score, valid] + ([fg] if fg is not None else [])):
        raise ValueError("all inputs must be on one device")
    strides = (ctypes.c_longlong * 18)(*(s for t in qkv for s in t.stride()[:3]))
    out_c, out_r, attn, scratch = _buffers(B, h, q, k, d, qc.device)
    lib = library.load()
    fg_ptr = None if fg is None else fg.data_ptr()
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in qkv] + [score.data_ptr(), fg_ptr, valid.data_ptr(),
                                              out_c.data_ptr(), out_r.data_ptr(),
                                              attn.data_ptr()]
        if scratch is None:
            rc = lib.tscd_fused_dual_attention_stream(
                *ptrs, strides, B, h, q, k, d, float(scale), int(bf16), stream)
        else:
            rc = lib.tscd_fused_dual_attention(
                *ptrs, scratch.data_ptr(), 4 * scratch.numel(), strides, B, h, q, k, d,
                float(scale), int(bf16), stream)
    library.check(lib, rc, f"fused_dual_attention ({route(q)})")
    fused_dual_attention.launches += 1
    return out_c, out_r, attn


fused_dual_attention.launches = 0
fused_dual_attention.backward_calls = 0
