"""Hand CUDA kernels for Hopper (sm_90a), one module per TPU kernel of
the JAX package:

  focus_stem       <- tscd_tpu/ops/pallas/focus_stem.py
  fused_attention  <- tscd_tpu/ops/pallas/fused_attention.py
  hungarian        <- tscd_tpu/ops/pallas/hungarian.py (n <= 128) and
                      the XLA lowering of tscd_tpu/ops/hungarian.py (n > 128)
  nms              <- the IoU matrix and XLA scan of tscd_tpu/ops/nms.py
                      (no Pallas kernel)
  int8_conv        <- the XLA int8 conv of tscd_tpu/models/blocks.py:347-353
                      (no Pallas kernel): abs max, quantize, weight packing
                      and the implicit-GEMM conv of the int8 serving mode

Each module holds the wrapper (checks its arguments and calls the
kernel's torch op), the launcher (the op's CUDA implementation, which
launches the kernel and counts the launch in `<wrapper>.launches`), the
plain PyTorch version of the same function (the op's CPU
implementation), and a note on what bounds the kernel. `ops` registers
the ops (namespace `tscd`) when this package is imported. Sources live in
`tscd_torch/csrc/`; `library.load()` builds them with nvcc at first use.
"""

from . import int8_conv, ops
from .int8_conv import (abs_max, epilogue_reference, int8_conv_reference, pack_int8_weight,
                        pack_reference, quantize_int8_activation, quantize_reference)

__all__ = ["int8_conv", "ops", "abs_max", "quantize_int8_activation", "pack_int8_weight",
           "quantize_reference", "pack_reference", "int8_conv_reference", "epilogue_reference"]
