"""Fused dual-branch proposal attention (kernel 1 of the port).

Replaces tscd_tpu/ops/pallas/fused_attention.py (`_fused_forward` ->
`_kernel`), the hot op of MCA aggregation (aggregation.py:110). CUDA
source: tscd_torch/csrc/fused_attention.cu. Per head: L2-normalised q/k
of both branches, lc = 25 q^c.k^c * score[k], lr = 25 q^r.k^r, -1e9 on
invalid keys, attn = (softmax(lc) + softmax(lr)) / 2, and attn@Vc,
attn@Vr. The kernel writes attn, which the round-2 pooling reads.

Bound on an H100 at the main-path shape (B=1, h=4, q=50, k=1600, d=64):
8.0 MB moved (2.40 us at 3.35 TB/s) and 0.164 GFLOP of fp32 FMA (2.45 us
at 67 TFLOP/s), so operations bound it, by a hair; the simple kernel's
28 blocks leave most SMs idle and it is latency bound in practice.
"""

from typing import Tuple

import torch

from . import library

NEG = -1e9


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def fused_dual_attention_plain(qc, kc, vc, qr, kr, vr, cls_score, key_valid,
                               scale: float = 25.0
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (dual_attention_reference with a batch axis).
    q* (B, h, q, d); k*/v* (B, h, k, d); cls_score (B, k); key_valid
    (B, k) bool. Returns out_cls, out_reg (B, h, q, d) and attn
    (B, h, q, k), all fp32."""
    f32 = torch.float32
    lc = torch.einsum("bhqd,bhkd->bhqk", _l2n(qc.to(f32)), _l2n(kc.to(f32))) * scale
    lr = torch.einsum("bhqd,bhkd->bhqk", _l2n(qr.to(f32)), _l2n(kr.to(f32))) * scale
    lc = lc * cls_score.to(f32)[:, None, None, :]
    neg = torch.where(key_valid, 0.0, NEG).to(f32)[:, None, None, :]
    attn = 0.5 * (torch.softmax(lc + neg, -1) + torch.softmax(lr + neg, -1))
    out_cls = torch.einsum("bhqk,bhkd->bhqd", attn, vc.to(f32))
    out_reg = torch.einsum("bhqk,bhkd->bhqd", attn, vr.to(f32))
    return out_cls, out_reg, attn


def fused_dual_attention(qc, kc, vc, qr, kr, vr, cls_score, key_valid,
                         scale: float = 25.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shapes as in `fused_dual_attention_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (fp32, d <= 128)."""
    if qc.device.type == "cpu":
        return fused_dual_attention_plain(qc, kc, vc, qr, kr, vr, cls_score,
                                          key_valid, scale)
    if qc.device.type != "cuda":
        raise ValueError(f"fused_dual_attention: unsupported device {qc.device}")
    B, h, q, d = qc.shape
    k = kc.shape[2]
    for t in (qc, qr):
        if t.shape != (B, h, q, d):
            raise ValueError(f"query shape {tuple(t.shape)} != {(B, h, q, d)}")
    for t in (kc, vc, kr, vr):
        if t.shape != (B, h, k, d):
            raise ValueError(f"key/value shape {tuple(t.shape)} != {(B, h, k, d)}")
    if cls_score.shape != (B, k) or key_valid.shape != (B, k):
        raise ValueError("cls_score / key_valid must be (B, k)")
    if key_valid.dtype != torch.bool:
        raise TypeError("key_valid must be bool")
    if not 1 <= d <= 128:
        raise ValueError(f"head dim {d} outside 1..128")
    ins = [t.to(torch.float32).contiguous()
           for t in (qc, kc, vc, qr, kr, vr, cls_score)]
    valid = key_valid.contiguous()
    if any(t.device != qc.device for t in ins + [valid]):
        raise ValueError("all inputs must be on one device")
    out_c = torch.empty(B, h, q, d, device=qc.device, dtype=torch.float32)
    out_r = torch.empty_like(out_c)
    attn = torch.empty(B, h, q, k, device=qc.device, dtype=torch.float32)
    lib = library.load()
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tscd_fused_dual_attention(
            *(t.data_ptr() for t in ins), valid.data_ptr(),
            out_c.data_ptr(), out_r.data_ptr(), attn.data_ptr(),
            B, h, q, k, d, float(scale), stream)
    library.check(lib, rc, "fused_dual_attention")
    fused_dual_attention.launches += 1
    return out_c, out_r, attn


fused_dual_attention.launches = 0
