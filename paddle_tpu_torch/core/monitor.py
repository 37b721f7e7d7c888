"""Named counters, gauges, labeled gauges and histograms (counterpart of
``paddle_tpu/core/monitor.py``; reference: paddle/fluid/platform/
monitor.h:77 StatRegistry, STAT_ADD :130). The serving engines own
registries of their own; the process-wide one (:func:`default_registry`,
written by :func:`stat_add`, :func:`stat_set`, :func:`stat_set_labeled`
and :func:`stat_observe`) holds the stats of process-wide subsystems, as
the reference's does: ``amp.*``, ``train.*`` (the step meter) and the
tracer's ``observability.*``. :meth:`StatRegistry.snapshot` is the one
consistent view that the Prometheus render and the flight dump read.
:func:`device_memory_stats` reads ``torch.cuda.memory_stats``."""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Tuple, Union

import torch

Number = Union[int, float]

#: sorted ``(key, value)`` pairs: the identity of one labeled series.
LabelSet = Tuple[Tuple[str, str], ...]

#: default reservoir bound per histogram (quantiles track recent samples).
DEFAULT_HIST_SAMPLES = 2048


class _Histogram:
    """All-time count/sum/min/max; quantiles over the newest samples.
    Only its registry touches it, under the registry's lock."""

    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self, max_samples: int = DEFAULT_HIST_SAMPLES):
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

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        pos = min(max(q, 0.0), 1.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

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
    """Thread-safe scalar stats (``add`` counts, ``set`` gauges), labeled
    gauges and histograms (``observe``), read by name, by dotted prefix
    or all at once (``snapshot``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Number] = {}
        self._hists: Dict[str, _Histogram] = {}
        self._labeled: Dict[str, Dict[LabelSet, Number]] = {}
        # exposition kind per scalar: "counter" (add) or "gauge" (set);
        # the first writer wins, so the TYPE line stays stable
        self._kinds: Dict[str, str] = {}

    def add(self, name: str, value: Number) -> Number:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + value
            self._kinds.setdefault(name, "counter")
            return self._stats[name]

    def set(self, name: str, value: Number):
        with self._lock:
            self._stats[name] = value
            self._kinds.setdefault(name, "gauge")

    def get(self, name: str, default: Number = 0) -> Number:
        with self._lock:
            return self._stats.get(name, default)

    def set_labeled(self, name: str, labels: Dict[str, str], value: Number):
        """A gauge with label dimensions, one series per label set; the
        labels are sorted, so their order never forks a series."""
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with self._lock:
            self._labeled.setdefault(name, {})[key] = value

    def labeled(self, name: str) -> Dict[LabelSet, Number]:
        with self._lock:
            return dict(self._labeled.get(name, {}))

    def reset(self, name: str = None):
        with self._lock:
            if name is None:
                self._stats.clear()
                self._hists.clear()
                self._labeled.clear()
                self._kinds.clear()
            else:
                self._stats.pop(name, None)
                self._hists.pop(name, None)
                self._labeled.pop(name, None)
                self._kinds.pop(name, None)

    def stats(self) -> Dict[str, Number]:
        with self._lock:
            return dict(self._stats)

    def stats_with_prefix(self, prefix: str) -> Dict[str, Number]:
        with self._lock:
            return {k: v for k, v in self._stats.items()
                    if k.startswith(prefix)}

    def observe(self, name: str, value: Number,
                max_samples: int = DEFAULT_HIST_SAMPLES):
        """One sample of a distribution; quantiles read the newest
        ``max_samples``."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram(max_samples)
            h.observe(value)

    def quantile(self, name: str, q: float, default: float = 0.0) -> float:
        with self._lock:
            h = self._hists.get(name)
            return h.quantile(q) if h is not None else default

    def histogram(self, name: str) -> Dict[str, float]:
        """count/sum/min/max/mean/p50/p95/p99; zeros if never observed."""
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else _Histogram(1).summary()

    def histograms(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()}

    def histograms_with_prefix(self, prefix: str) -> Dict[str, Dict]:
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()
                    if k.startswith(prefix)}

    def snapshot(self) -> Dict[str, Dict]:
        """Every stat, kind, histogram and labeled series under ONE lock
        acquisition, so a counter never disagrees with its histogram.
        The exposition paths (Prometheus, ``print_stats``, flight dumps)
        read this."""
        with self._lock:
            return {
                "stats": dict(self._stats),
                "kinds": dict(self._kinds),
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
                "labeled": {k: dict(v) for k, v in self._labeled.items()},
            }

    def print_stats(self):
        snap = self.snapshot()
        for k, v in sorted(snap["stats"].items()):
            print(f"STAT {k} = {v}")
        for k, s in sorted(snap["histograms"].items()):
            print(f"HIST {k} = count={s['count']} p50={s['p50']:.6g} "
                  f"p95={s['p95']:.6g} p99={s['p99']:.6g}")


_REGISTRY = StatRegistry()


def default_registry() -> StatRegistry:
    return _REGISTRY


def stat_add(name: str, value: Number) -> Number:
    """reference: monitor.h:130 STAT_ADD."""
    return _REGISTRY.add(name, value)


def stat_set(name: str, value: Number):
    _REGISTRY.set(name, value)


def stat_get(name: str, default: Number = 0) -> Number:
    return _REGISTRY.get(name, default)


def stat_set_labeled(name: str, labels: Dict[str, str], value: Number):
    """A labeled gauge on the default registry."""
    _REGISTRY.set_labeled(name, labels, value)


def stat_observe(name: str, value: Number,
                 max_samples: int = DEFAULT_HIST_SAMPLES):
    """A histogram sample on the default registry."""
    _REGISTRY.observe(name, value, max_samples)


def stat_quantile(name: str, q: float, default: float = 0.0) -> float:
    """The q-quantile (0..1) of a histogram's newest samples, or
    ``default``."""
    return _REGISTRY.quantile(name, q, default)


def stats_with_prefix(prefix: str) -> Dict[str, Number]:
    return _REGISTRY.stats_with_prefix(prefix)


def histograms_with_prefix(prefix: str) -> Dict[str, Dict[str, float]]:
    return _REGISTRY.histograms_with_prefix(prefix)


def device_memory_stats(device=None) -> Dict[str, Number]:
    """The caching allocator's numeric stats for a CUDA device
    (``torch.cuda.memory_stats``); empty for the CPU."""
    from .device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return {k: v for k, v in torch.cuda.memory_stats(dev).items()
            if isinstance(v, (int, float))}
