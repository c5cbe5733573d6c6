"""LR schedules (counterpart of tscd_tpu/train/lr.py; reference
yolox/utils/lr_scheduler.py:9): functions iteration -> LR on the host.
The LR of update n is schedule(n), n counted from 0 before the update."""

import math
from typing import Callable, Sequence


def yolox_warm_cos_lr(lr: float, min_lr_ratio: float, total_iters: int,
                      warmup_iters: int, warmup_lr_start: float,
                      no_aug_iters: int) -> Callable[[int], float]:
    """Quadratic warm-up, then cosine down to lr * min_lr_ratio, held at
    that floor over the no-aug tail (lr_scheduler.py:121-148)."""
    min_lr = lr * min_lr_ratio
    cos_iters = max(total_iters - warmup_iters - no_aug_iters, 1)

    def schedule(it: int) -> float:
        if it >= total_iters - no_aug_iters:
            return min_lr
        if it < warmup_iters:
            return ((lr - warmup_lr_start) * (it / max(warmup_iters, 1)) ** 2
                    + warmup_lr_start)
        progress = min(max((it - warmup_iters) / cos_iters, 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * progress))

    return schedule


def cos_lr(lr: float, total_iters: int) -> Callable[[int], float]:
    return lambda it: lr * 0.5 * (1.0 + math.cos(math.pi * it / total_iters))


def warm_cos_lr(lr: float, total_iters: int, warmup_iters: int,
                warmup_lr_start: float = 1e-6) -> Callable[[int], float]:
    def schedule(it: int) -> float:
        if it < warmup_iters:
            return (lr - warmup_lr_start) * it / max(warmup_iters, 1) + warmup_lr_start
        return lr * 0.5 * (1.0 + math.cos(
            math.pi * (it - warmup_iters) / (total_iters - warmup_iters)))
    return schedule


def multistep_lr(lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Callable[[int], float]:
    return lambda it: lr * gamma ** sum(it >= m for m in milestones)
