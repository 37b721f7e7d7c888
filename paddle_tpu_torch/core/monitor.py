"""Named counters, gauges and histograms (counterpart of the parts of
``paddle_tpu/core/monitor.py`` the serving engines use). A registry is an
object its owner creates; there is no process-wide default."""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Union

Number = Union[int, float]


class _Histogram:
    """All-time count/sum/min/max; quantiles over the newest samples.
    Only its registry touches it, under the registry's lock."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self, max_samples: int = 2048):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples = deque(maxlen=max_samples)

    def observe(self, value: Number):
        v = float(value)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.samples.append(v)

    def summary(self) -> Dict[str, float]:
        xs = sorted(self.samples)

        def _q(q):
            if not xs:
                return 0.0
            pos = q * (len(xs) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

        n = self.count
        return {"count": n, "sum": self.total,
                "min": self.vmin if n else 0.0,
                "max": self.vmax if n else 0.0,
                "mean": self.total / n if n else 0.0,
                "p50": _q(0.50), "p95": _q(0.95), "p99": _q(0.99)}


class StatRegistry:
    """Thread-safe scalar stats (``add``/``set``) and histograms
    (``observe``), read by dotted prefix."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Number] = {}
        self._hists: Dict[str, _Histogram] = {}

    def add(self, name: str, value: Number) -> Number:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + value
            return self._stats[name]

    def set(self, name: str, value: Number):
        with self._lock:
            self._stats[name] = value

    def get(self, name: str, default: Number = 0) -> Number:
        with self._lock:
            return self._stats.get(name, default)

    def observe(self, name: str, value: Number):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(value)

    def stats_with_prefix(self, prefix: str) -> Dict[str, Number]:
        with self._lock:
            return {k: v for k, v in self._stats.items()
                    if k.startswith(prefix)}

    def histograms_with_prefix(self, prefix: str) -> Dict[str, Dict]:
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()
                    if k.startswith(prefix)}
