"""PyTorch/CUDA port of the TSCD video object detector.

Runs the TSCD-Large streaming eval and stage-2 training, and the OVIS
recipe's still-image YOLOX stage 1, on an NVIDIA Hopper card. The
three TPU kernels of the JAX package (`tscd_tpu/ops/pallas/`) are hand
CUDA kernels here (`tscd_torch/csrc/`), each with a plain PyTorch version
beside it that CPU tensors take. This package imports torch and numpy
only.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
