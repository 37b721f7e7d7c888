"""Traffic traces: record from a live Router, replay with fidelity
(counterpart of ``paddle_tpu/serving/fleet/replay.py``; the same record
format, the same seeded synthesis, record for record, and the same
report).

A trace is a list of records ``{"t": <seconds since trace start>,
"prompt_len": n, "phase": "prefill"|"decode"|null, "max_new_tokens": k}``
— arrival time and shape, never payload (prompts are regenerated
deterministically at replay, so traces are shareable between the
packages). On disk it is JSONL, one record per line, ordered by ``t``.

:class:`TraceRecorder` hooks ``Router.set_trace_recorder`` and captures
every ACCEPTED request. :func:`synthesize_trace` builds a seeded Poisson
storm when no recorded trace exists. :class:`TraceReplayer` replays a
trace against a router with arrival-time fidelity — each record is
dispatched at ``t0 + record.t`` regardless of how long earlier requests
took — and client-side retries: a request that fails with a retryable
serving error (killed replica, draining race, no-replica window) is
re-submitted up to ``max_retries`` times, as a production client treats
503s. A record whose every attempt fails is a **drop**. All of it is
host code: the router's engines own the device.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Dict, List, Optional

import numpy as np

from ..request import ServingError

__all__ = ["TraceRecorder", "synthesize_trace", "save_trace", "load_trace",
           "TraceReplayer"]


# -- trace capture / synthesis / persistence ----------------------------------

class TraceRecorder:
    """Router hook capturing (arrival offset, prompt length, phase) for
    every accepted request. Thread-safe; install via
    ``router.set_trace_recorder(recorder)``."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self.records: List[Dict] = []

    def on_request(self, args, kwargs, phase):
        now = self._clock()
        prompt = args[0] if args else kwargs.get("prompt")
        try:
            n = len(prompt)
        except TypeError:
            n = 1
        mnt = kwargs.get("max_new_tokens")
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.records.append({
                "t": round(now - self._t0, 6),
                "prompt_len": int(n),
                "phase": phase,
                "max_new_tokens": int(mnt) if mnt is not None else None,
            })

    def __len__(self):
        with self._lock:
            return len(self.records)

    def trace(self) -> List[Dict]:
        with self._lock:
            return list(self.records)


def synthesize_trace(n_requests: int, rate_rps: float, *, seed: int = 0,
                     prompt_len_range=(4, 24),
                     max_new_tokens: int = 8) -> List[Dict]:
    """A deterministic Poisson request storm: exponential interarrivals
    at ``rate_rps``, prompt lengths uniform over ``prompt_len_range``.
    Same seed → same trace (NumPy's ``default_rng``, drawn in the JAX
    package's order, so both packages give the same records)."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_len_range
    t = 0.0
    out = []
    for _ in range(int(n_requests)):
        t += float(rng.exponential(1.0 / float(rate_rps)))
        out.append({
            "t": round(t, 6),
            "prompt_len": int(rng.integers(lo, hi + 1)),
            "phase": None,
            "max_new_tokens": int(max_new_tokens),
        })
    return out


def save_trace(records: List[Dict], path: str):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    out.sort(key=lambda r: r.get("t", 0.0))
    return out


# -- replay -------------------------------------------------------------------

class TraceReplayer:
    """Replay a trace against a Router with arrival-time fidelity.

    The dispatching thread sleeps to each record's absolute schedule
    (``t0 + record.t`` — queueing delay never skews later arrivals) and
    hands the record to a pool worker, which submits, waits for the
    result, and retries retryable failures. ``run()`` blocks until every
    record resolved and returns the replay report."""

    #: failures a production client would retry (the request never
    #: produced output): hard-killed engine, drain/pause races, the
    #: window where no replica is admissible, and LLM-worker death.
    RETRYABLE = (ServingError, RuntimeError, TimeoutError, _FutTimeout)

    def __init__(self, router, trace: List[Dict], *,
                 vocab: int = 64, max_retries: int = 25,
                 retry_delay: float = 0.05,
                 request_timeout: float = 60.0,
                 default_max_new_tokens: int = 8,
                 workers: int = 32, clock=time.monotonic):
        self.router = router
        self.trace = list(trace)
        self.vocab = int(vocab)
        self.max_retries = int(max_retries)
        self.retry_delay = float(retry_delay)
        self.request_timeout = float(request_timeout)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.workers = int(workers)
        self._clock = clock
        self._lock = threading.Lock()
        self._completed = 0
        self._dropped = 0
        self._retries = 0
        self._latency_ms: List[float] = []
        self._arrival_lag_ms: List[float] = []
        self._versions: Dict[int, int] = {}   # weights_version -> count

    def _prompt_for(self, idx: int, n: int) -> List[int]:
        # deterministic per-record prompt: replays are comparable without
        # shipping payloads in the trace
        return [1 + (idx * 7 + j * 3) % (self.vocab - 1)
                for j in range(max(1, n))]

    def run(self) -> dict:
        t_start = self._clock()
        with ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix="fleet-replay") as pool:
            futs = []
            for idx, rec in enumerate(self.trace):
                due = t_start + float(rec.get("t", 0.0))
                delay = due - self._clock()
                if delay > 0:
                    time.sleep(delay)
                lag = max(0.0, (self._clock() - due) * 1000.0)
                with self._lock:
                    self._arrival_lag_ms.append(lag)
                futs.append(pool.submit(self._one, idx, rec, due))
            for f in futs:
                f.result()
        wall = self._clock() - t_start
        return self.report(wall)

    def _one(self, idx: int, rec: Dict, due: float):
        prompt = self._prompt_for(idx, int(rec.get("prompt_len", 1)))
        mnt = rec.get("max_new_tokens") or self.default_max_new_tokens
        attempts = 0
        while attempts <= self.max_retries:
            attempts += 1
            try:
                out = self.router.submit(prompt, max_new_tokens=mnt)
                res = out.result(timeout=self.request_timeout)
                break
            except self.RETRYABLE:
                with self._lock:
                    self._retries += 1
                time.sleep(self.retry_delay)
        else:
            with self._lock:
                self._dropped += 1
            return
        latency = (self._clock() - due) * 1000.0
        with self._lock:
            self._completed += 1
            self._latency_ms.append(latency)
            if isinstance(res, dict) and "weights_version" in res:
                v = res["weights_version"]
                self._versions[v] = self._versions.get(v, 0) + 1

    @staticmethod
    def _q(xs: List[float], q: float) -> float:
        if not xs:
            return 0.0
        ys = sorted(xs)
        pos = min(max(q, 0.0), 1.0) * (len(ys) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(ys) - 1)
        return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)

    def report(self, wall_s: float) -> dict:
        with self._lock:
            return {
                "offered": len(self.trace),
                "completed": self._completed,
                "dropped": self._dropped,
                "retries": self._retries,
                "wall_s": wall_s,
                "latency_p50_ms": self._q(self._latency_ms, 0.50),
                "latency_p95_ms": self._q(self._latency_ms, 0.95),
                # proof of arrival fidelity: how late the replayer actually
                # dispatched each record vs its schedule
                "arrival_lag_p95_ms": self._q(self._arrival_lag_ms, 0.95),
                # weights_version histogram of completed requests: during
                # a mid-storm roll both versions appear, mixed never
                "weights_versions": dict(self._versions),
            }
