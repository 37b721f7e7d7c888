"""Wall-clock budgets (counterpart of ``Deadline`` and
``DeadlineExceeded`` in ``paddle_tpu/utils/resilience.py``)."""
from __future__ import annotations

import time
from typing import Optional


class DeadlineExceeded(TimeoutError):
    pass


class Deadline:
    """A wall-clock budget. ``clock`` is injectable so tests never sleep."""

    def __init__(self, seconds: Optional[float], clock=time.monotonic):
        self._clock = clock
        self.seconds = None if seconds is None else float(seconds)
        self._t0 = clock()

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation"):
        if self.expired():
            raise DeadlineExceeded(
                f"{what} exceeded its {self.seconds}s deadline")
