"""DynamicBatcher: coalesce queued requests into one bucketed batch
(counterpart of ``paddle_tpu/serving/batcher.py``).

Policy: take the head request, then keep taking compatible requests (same
sequence bucket, total rows still fit the largest batch bucket) for up to
``max_batch_delay`` seconds, the throughput/latency knob. The row count
is rounded up to the smallest batch bucket that holds it, so the
dispatched shape always comes from the closed bucket set.

A head request larger than every bucket becomes an *oversize* batch of
one request; the engine either splits it into max-bucket chunks or
rejects it at submit time, per configuration. Coalescing (not the idle
wait for a first request) is a ``serving/form_batch`` span.
"""
from __future__ import annotations

import time
from typing import List, Optional

from ..observability import tracer as _otrace
from .buckets import BucketSpec
from .queue import BatchQueue
from .request import InferenceRequest


class Batch:
    """One dispatchable unit: requests + the padded shape they run at."""

    __slots__ = ("requests", "bucket_rows", "seq_bucket", "rows", "oversize")

    def __init__(self, requests: List[InferenceRequest],
                 bucket_rows: Optional[int], seq_bucket: Optional[int] = None,
                 oversize: bool = False):
        self.requests = requests
        self.rows = sum(r.nrows for r in requests)
        self.bucket_rows = bucket_rows
        self.seq_bucket = seq_bucket
        self.oversize = oversize

    @property
    def fill_ratio(self) -> float:
        if not self.bucket_rows:
            return 1.0
        return self.rows / float(self.bucket_rows)


class DynamicBatcher:
    """Pulls from a :class:`BatchQueue` and forms bucketed batches."""

    def __init__(self, queue: BatchQueue, buckets: BucketSpec,
                 max_batch_delay: float = 0.005, clock=time.monotonic):
        self._queue = queue
        self._buckets = buckets
        self._max_delay = max(0.0, float(max_batch_delay))
        self._clock = clock

    def next_batch(self, timeout: Optional[float] = None) -> Optional[Batch]:
        """Block up to ``timeout`` for a first request; then coalesce for at
        most ``max_batch_delay``. None on an empty-queue timeout."""
        first = self._queue.take(timeout=timeout)
        if first is None:
            return None
        with _otrace.span("serving/form_batch"):
            return self._coalesce(first)

    def _coalesce(self, first: InferenceRequest) -> Batch:
        spec = self._buckets
        if first.nrows > spec.max_batch:
            return Batch([first], bucket_rows=None,
                         seq_bucket=spec.seq_bucket_for(first.seq_len()),
                         oversize=True)

        seq_bucket = spec.seq_bucket_for(first.seq_len())
        requests = [first]
        rows = first.nrows
        t0 = self._clock()
        while rows < spec.max_batch:
            remaining = self._max_delay - (self._clock() - t0)
            if remaining <= 0:
                break
            budget = spec.max_batch - rows

            def _fits(r: InferenceRequest) -> bool:
                return (r.nrows <= budget
                        and spec.seq_bucket_for(r.seq_len()) == seq_bucket)

            nxt = self._queue.take(timeout=remaining, fits=_fits)
            if nxt is None:
                break
            requests.append(nxt)
            rows += nxt.nrows
        return Batch(requests, bucket_rows=spec.batch_bucket_for(rows),
                     seq_bucket=seq_bucket)
