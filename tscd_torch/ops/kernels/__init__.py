"""Hand CUDA kernels for Hopper (sm_90a), one module per TPU kernel of
the JAX package:

  focus_stem       <- tscd_tpu/ops/pallas/focus_stem.py
  fused_attention  <- tscd_tpu/ops/pallas/fused_attention.py
  hungarian        <- tscd_tpu/ops/pallas/hungarian.py

Each module holds the wrapper (launches the kernel on a CUDA tensor and
counts the launch in `<wrapper>.launches`), the plain PyTorch version of
the same function (taken for CPU tensors only), and a note on what bounds
the kernel. Sources live in `tscd_torch/csrc/`; `library.load()` builds
them with nvcc at first use.
"""
