"""Eval Focus stem (kernel 3 of the port).

Replaces tscd_tpu/ops/pallas/focus_stem.py (`_focus_stem_impl` ->
`_kernel`); in the JAX package the same math runs as an XLA conv
(blocks.py:596). CUDA source: tscd_torch/csrc/focus_stem.cu. The stem,
space-to-depth + 3x3 conv + BN + SiLU, is one 6x6 stride-2 conv over the
raw (F, H, W, 3) image with the BN scale folded into the weights, then
+ shift and SiLU.

Bound on an H100 at (32, 576, 576, 3) -> 64 channels: 127 MB read,
679 MB written (0.24 ms) and 36.7 GFLOP of fp32 FMA (0.55 ms at the
67 TFLOP/s non-tensor peak), so operations bound it.
"""

import torch
import torch.nn.functional as F

from . import library


def rearrange_weight(w3: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Focus conv weight (O, 4C, 3, 3) in torch layout, s2d channel order
    (dx*2+dy)*C + c, times the folded BN scale (O,) -> the equivalent
    6x6 stride-2 kernel (O, C, 6, 6), with ky = 2u+dy and kx = 2v+dx."""
    O, C4, k, _ = w3.shape
    C = C4 // 4
    w6 = w3.reshape(O, 2, 2, C, k, k)                  # (o, dx, dy, c, u, v)
    w6 = w6.permute(0, 3, 4, 2, 5, 1).reshape(O, C, 2 * k, 2 * k)
    return w6 * scale[:, None, None, None]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(F, C, H, W) -> (F, 4C, H/2, W/2) in the reference's channel order
    (top-left, bottom-left, top-right, bottom-right; network_blocks.py:274)."""
    return torch.cat([x[..., 0::2, 0::2], x[..., 1::2, 0::2],
                      x[..., 0::2, 1::2], x[..., 1::2, 1::2]], 1)


def focus_stem_plain(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version in the Focus module's own terms: s2d, the
    3x3 conv, folded BN, SiLU. x (F, H, W, 3) NHWC fp32; w3 (O, 12, 3, 3);
    scale/shift (O,). Returns (F, O, H/2, W/2)."""
    xs = space_to_depth(x.permute(0, 3, 1, 2).to(torch.float32))
    y = F.conv2d(xs, w3.to(torch.float32), padding=w3.shape[-1] // 2)
    y = y * scale[None, :, None, None] + shift[None, :, None, None]
    return F.silu(y)


def focus_stem(x: torch.Tensor, w3: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """Fused eval stem. Arguments as in `focus_stem_plain`. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, which
    writes (F, H/2, W/2, O), returned as the (F, O, H/2, W/2) tensor in
    channels_last memory."""
    if x.device.type == "cpu":
        return focus_stem_plain(x, w3, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"focus_stem: unsupported device {x.device}")
    Fr, H, W, C = x.shape
    O = w3.shape[0]
    if C != 3 or w3.shape != (O, 4 * C, 3, 3):
        raise ValueError(f"focus_stem takes (F, H, W, 3) and (O, 12, 3, 3), "
                         f"got {tuple(x.shape)} and {tuple(w3.shape)}")
    if H % 2 or W % 2 or O % 8:
        raise ValueError("focus_stem needs even H, W and O a multiple of 8")
    xin = x.to(torch.float32).contiguous()
    w6 = rearrange_weight(w3.to(torch.float32), scale.to(torch.float32))
    wk = w6.permute(2, 3, 1, 0).contiguous()           # (ky, kx, c, o)
    sh = shift.to(torch.float32).contiguous()
    out = torch.empty(Fr, H // 2, W // 2, O, device=x.device,
                      dtype=torch.float32)
    lib = library.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tscd_focus_stem(xin.data_ptr(), wk.data_ptr(), sh.data_ptr(),
                                 out.data_ptr(), Fr, H, W, C, O, stream)
    library.check(lib, rc, "focus_stem")
    focus_stem.launches += 1
    return out.permute(0, 3, 1, 2)


focus_stem.launches = 0
