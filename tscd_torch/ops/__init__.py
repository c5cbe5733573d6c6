"""Tensor functions of the port: boxes, decode, NMS, Haar wavelets,
assignment, postprocess, and the hand kernels under `ops.kernels`."""
