"""Crash flight recorder: the last events, spans and stats, dumped on a
failure (counterpart of ``paddle_tpu/observability/flight.py``).

A bounded ring (a deque, lock-free under the GIL as the span tracer's)
records cheap structured events: drain transitions, engine deaths,
training-loop exceptions. On a terminal event the ring is dumped as
JSONL, so the post-mortem has the timeline that led to the exit:

* an **unhandled exception** in a guarded loop (``Model.fit``, the LLM
  engine's worker);
* a **SIGTERM drain**: the engines' drain path, or
  :func:`install_signal_dump` on the shared ``ChainedSignalHandler``.

The dump (``flight_<ts>_<pid>.jsonl``) is the JAX package's schema
``paddle-tpu-flight/2``: line 1 is a header (``schema``, ``reason``,
``pid``, ``wall_s``, ``argv``, ``cohort_generation``,
``process_index``, ``process_count``), then one line per event
(``{"kind": ...}``), then the newest spans (``{"kind": "span", ...}``)
and a final ``{"kind": "stats", ...}`` registry snapshot, so the JAX
package's ``tools/trace_export.py`` converts it.

Dumping is opt-in ("armed"): ``PADDLE_TPU_FLIGHT=1``, :func:`arm`, or
``observability.enable()``; ``PADDLE_TPU_FLIGHT_DIR`` names the
directory (the working directory by default). Recording into the ring
is always on.
"""
from __future__ import annotations

import json
import os
import sys
import time
from collections import deque
from typing import Dict, List, Optional

from ..core import monitor as _monitor
from . import tracer as _tracer

SCHEMA = "paddle-tpu-flight/2"

DEFAULT_CAPACITY = int(os.environ.get("PADDLE_TPU_FLIGHT_CAPACITY", "512"))

#: how many of the newest spans a dump includes
DUMP_SPAN_LIMIT = 256


def _cohort_generation() -> int:
    """Cohort generation stamped by the elastic supervisor (0 outside it)."""
    try:
        return int(os.environ.get("PADDLE_TPU_COHORT_GEN", "0"))
    except ValueError:
        return 0


def _process_identity() -> Dict:
    """``process_index``/``process_count`` for the dump header, read from
    the PADDLE_* env contract (always set under the launcher) rather than
    asked of torch: a crash-path writer must never start a device or
    a collective, least of all while a peer is already dead."""
    try:
        return {
            "process_index": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
            "process_count": int(os.environ.get("PADDLE_TRAINERS_NUM", "1")),
        }
    except ValueError:
        return {"process_index": 0, "process_count": 1}


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events = deque(maxlen=capacity)  # GIL-atomic append
        self.armed = False
        self.last_dump_path: Optional[str] = None

    def record(self, kind: str, fields: Optional[Dict] = None):
        ev = {"kind": kind, "wall_s": time.time()}
        if fields:
            ev.update(fields)
        self._events.append(ev)

    def events(self) -> List[Dict]:
        return list(self._events)

    def clear(self):
        self._events.clear()

    def dump(self, reason: str, directory: Optional[str] = None,
             registry: Optional["_monitor.StatRegistry"] = None,
             tracer: Optional["_tracer.SpanTracer"] = None) -> str:
        """Write the flight JSONL; returns the path. Never raises (a
        post-mortem writer must not mask the original failure) — on write
        error it returns the path it attempted."""
        directory = (directory
                     or os.environ.get("PADDLE_TPU_FLIGHT_DIR")
                     or os.getcwd())
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(directory,
                            f"flight_{ts}_{os.getpid()}.jsonl")
        t = tracer if tracer is not None else _tracer.default_tracer()
        reg = registry if registry is not None else _monitor.default_registry()
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w") as f:
                header = {
                    "schema": SCHEMA,
                    "reason": reason,
                    "pid": os.getpid(),
                    "wall_s": time.time(),
                    "argv": list(sys.argv),
                    "cohort_generation": _cohort_generation(),
                }
                header.update(_process_identity())
                f.write(json.dumps(header, default=str) + "\n")
                for ev in list(self._events):
                    f.write(json.dumps(ev, default=str) + "\n")
                for s in t.spans()[-DUMP_SPAN_LIMIT:]:
                    rec = {"kind": "span"}
                    rec.update(s)
                    f.write(json.dumps(rec, default=str) + "\n")
                snap = reg.snapshot()
                f.write(json.dumps({"kind": "stats",
                                    "stats": snap["stats"],
                                    "histograms": snap["histograms"]},
                                   default=str) + "\n")
        except OSError as e:
            sys.stderr.write(f"[paddle_tpu.flight] dump to {path} "
                             f"failed: {e}\n")
        self.last_dump_path = path
        return path


_RECORDER = FlightRecorder()


def default_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind: str, fields: Optional[Dict] = None):
    """Append one event to the default flight ring (always cheap/on)."""
    _RECORDER.record(kind, fields)


def arm():
    """Enable crash-path dumps (sentinel halt / unhandled exception /
    SIGTERM drain). Recording is always on; arming controls file output."""
    _RECORDER.armed = True


def disarm():
    _RECORDER.armed = False


def is_armed() -> bool:
    return _RECORDER.armed


def dump(reason: str, directory: Optional[str] = None) -> str:
    return _RECORDER.dump(reason, directory=directory)


def dump_if_armed(reason: str) -> Optional[str]:
    """Crash-path hook: dump only when armed, never raise."""
    if not _RECORDER.armed:
        return None
    return _RECORDER.dump(reason)


def install_signal_dump(signum: Optional[int] = None):
    """Chain a flight dump onto SIGTERM (preemption) via the shared
    ChainedSignalHandler — previously-installed handlers (engine drain,
    elastic supervisor) still run. Returns the handler (``uninstall()``
    to remove); None off the main thread."""
    import signal as _signal
    from ..distributed.elastic import ChainedSignalHandler

    sig = signum if signum is not None else _signal.SIGTERM

    def _on_signal(s, frame):
        record_event("signal", {"signum": s})
        dump_if_armed("signal_%d" % s)

    h = ChainedSignalHandler(_on_signal, signals=(sig,))
    h.install()
    return h if h.installed else None


if os.environ.get("PADDLE_TPU_FLIGHT", "").lower() in ("1", "true", "on"):
    arm()
