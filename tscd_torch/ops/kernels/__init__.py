"""Hand CUDA kernels for Hopper (sm_90a), one module per TPU kernel of
the JAX package:

  focus_stem       <- tscd_tpu/ops/pallas/focus_stem.py
  fused_attention  <- tscd_tpu/ops/pallas/fused_attention.py
  hungarian        <- tscd_tpu/ops/pallas/hungarian.py (n <= 128) and
                      the XLA lowering of tscd_tpu/ops/hungarian.py (n > 128)
  nms              <- the IoU matrix and XLA scan of tscd_tpu/ops/nms.py
                      (no Pallas kernel)

Each module holds the wrapper (launches the kernel on a CUDA tensor and
counts the launch in `<wrapper>.launches`), the plain PyTorch version of
the same function (taken for CPU tensors only), and a note on what bounds
the kernel. Sources live in `tscd_torch/csrc/`; `library.load()` builds
them with nvcc at first use.
"""
