"""Greedy NMS walk (a port kernel with no Pallas counterpart).

Replaces the XLA `lax.scan` of tscd_tpu/ops/nms.py:55 (`nms_fixed`), the
JAX package's exact greedy NMS, which runs K dependent steps on the
device and waits on nothing. CUDA source: tscd_torch/csrc/nms.cu.

Given, in score order, sup (B, K, K) bool with sup[b, i, j] = box j comes
before box i and overlaps it, and valid (B, K) bool, it returns keep
(B, K) bool with keep[i] = valid[i] & !any_{j < i}(sup[i, j] & keep[j]).

Bound: latency. The K decisions form one dependent chain; the kernel
packs the rows into bit words over the whole card, then one warp a frame
walks them with a word AND, one warp vote and a select a step. On the
main path it runs twice a window: over K = P * C = 1500 (proposal, class)
pairs and over K = P = 50 proposals.
"""

import torch

from . import library

_CHECK_EVERY = 8


def nms_walk_plain(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the fixed point of
    keep = valid & ~any_j(sup[i, j] & keep[j]), reached by masked
    matrix-vector products. After t steps the first t boxes are final and
    the greedy answer is the only fixed point, so the loop stops at the
    first step that changes nothing; convergence is tested every
    `_CHECK_EVERY` steps, one host read a test (harmless on the CPU,
    where this version runs)."""
    suppress = sup.to(torch.float32)
    keep = valid
    while True:
        for _ in range(_CHECK_EVERY):
            prev = keep
            hit = torch.bmm(suppress, keep.to(torch.float32)[..., None])[..., 0]
            keep = valid & ~(hit > 0)
        if torch.equal(keep, prev):
            return keep


def nms_walk(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sup (B, K, K) bool, strictly lower triangular in score order (only
    j < i is read), valid (B, K) bool -> keep (B, K) bool. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (K <= 8192)
    and never reads the host."""
    if sup.dim() != 3 or sup.shape[1] != sup.shape[2] or valid.shape != sup.shape[:2]:
        raise ValueError(f"nms_walk takes (B, K, K) and (B, K), got "
                         f"{tuple(sup.shape)} and {tuple(valid.shape)}")
    if sup.dtype != torch.bool or valid.dtype != torch.bool:
        raise ValueError("nms_walk takes bool tensors")
    if sup.device.type == "cpu":
        return nms_walk_plain(sup, valid)
    if sup.device.type != "cuda" or valid.device != sup.device:
        raise ValueError(f"nms_walk: unsupported devices {sup.device}, {valid.device}")
    B, K = valid.shape
    if not 1 <= K <= 8192 or B > 65535:
        raise ValueError(f"nms_walk takes 1 <= K <= 8192 and B <= 65535, got K = {K}, B = {B}")
    s = sup.contiguous()
    v = valid.contiguous()
    words = ((K + 31) // 32 + 3) // 4 * 4
    bits = torch.empty(B, K + 1, words, dtype=torch.int32, device=sup.device)
    keep = torch.empty(B, K, dtype=torch.bool, device=sup.device)
    lib = library.load()
    with torch.cuda.device(sup.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tscd_nms_walk(s.data_ptr(), v.data_ptr(), bits.data_ptr(),
                               keep.data_ptr(), B, K, stream)
    library.check(lib, rc, "nms_walk")
    nms_walk.launches += 1
    return keep


nms_walk.launches = 0
