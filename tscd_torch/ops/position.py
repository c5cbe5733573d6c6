"""Positional / timing embeddings (copy of tscd_tpu/ops/position.py)."""

import math

import numpy as np


def get_timing_signal_1d(index_sequence: np.ndarray, channels: int = 256,
                         min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> np.ndarray:
    """Sinusoidal absolute time embedding from frame indices
    (reference yolox/data/datasets/vid.py:1015). Host-side numpy;
    (N,) -> (N, channels)."""
    num_timescales = channels // 2
    log_incr = math.log(max_timescale / min_timescale) / (num_timescales - 1)
    inv_timescale = min_timescale * np.exp(
        np.arange(num_timescales) * -log_incr)
    scaled = np.asarray(index_sequence, np.float32)[:, None] * inv_timescale[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)
