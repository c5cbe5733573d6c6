"""Latency-budgeted frame batching for online serving (counterpart of
tscd_tpu/utils/batcher.py).

Streaming one frame a step pays the step's fixed cost on every frame; a
server may instead trade a bounded wait for batch size: accumulate
frames until `max_batch` are waiting or the OLDEST has waited
`max_wait_ms`, then flush them to one K-frame step
(`core.online.OnlineStream.run_batch`).

Host-side and model-agnostic; the clock is injectable so tests pin the
flush policy.
"""

import time
from typing import Any, Callable, List, Optional


class FrameBatcher:
    """Accumulate items; flush on size or on the age of the oldest item."""

    def __init__(self, max_batch: int, max_wait_ms: float = 25.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.clock = clock
        self._items: List[Any] = []
        self._oldest_t: Optional[float] = None

    def __len__(self) -> int:
        return len(self._items)

    def push(self, item: Any) -> Optional[List[Any]]:
        """Add a frame. Returns a full batch when `max_batch` is reached,
        else None (call `poll()` for the age-based flush)."""
        if not self._items:
            self._oldest_t = self.clock()
        self._items.append(item)
        if len(self._items) >= self.max_batch:
            return self.flush()
        return None

    def poll(self) -> Optional[List[Any]]:
        """Age-based flush: the pending batch if the oldest queued frame
        has waited at least `max_wait_ms`, else None."""
        if self._items and self._oldest_t is not None:
            if (self.clock() - self._oldest_t) * 1e3 >= self.max_wait_ms:
                return self.flush()
        return None

    def flush(self) -> Optional[List[Any]]:
        """Whatever is pending (None if nothing): call at the end of a
        stream so that no frame is dropped."""
        if not self._items:
            return None
        out = self._items
        self._items = []
        self._oldest_t = None
        return out
