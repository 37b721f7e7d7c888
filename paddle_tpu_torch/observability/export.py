"""Chrome ``trace_event`` export of recorded spans (counterpart of
``paddle_tpu/observability/export.py``).

The JSON object format (``{"traceEvents": [...]}``) that
``chrome://tracing`` and Perfetto load: one ``ph: "X"`` complete event
per span (microsecond timestamps) and ``M`` metadata events naming the
process and threads. The JAX package's ``tools/trace_export.py`` reads
the same records.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from . import tracer as _tracer


def to_trace_events(spans: List[Dict], pid: int = 0,
                    process_name: str = "paddle_tpu") -> List[Dict]:
    """Convert span records (tracer ring schema) to trace_event dicts."""
    events: List[Dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    seen_tids = {}
    for s in spans:
        tid = s.get("tid", 0)
        if tid not in seen_tids:
            seen_tids[tid] = s.get("thread", "") or f"tid-{tid}"
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": seen_tids[tid]},
            })
        ev = {
            "ph": "X",
            "name": s["name"],
            "pid": pid,
            "tid": tid,
            "ts": s["ts_ns"] / 1e3,      # trace_event wants microseconds
            "dur": s["dur_ns"] / 1e3,
        }
        args = dict(s.get("attrs") or {})
        if s.get("depth"):
            args["depth"] = s["depth"]
        if args:
            ev["args"] = args
        events.append(ev)
    return events


def export_chrome_trace(path: str, spans: Optional[List[Dict]] = None,
                        tracer: Optional["_tracer.SpanTracer"] = None,
                        drain: bool = False) -> int:
    """Write spans as Chrome trace JSON; returns the number of span events.

    Defaults to a non-destructive snapshot of the default tracer; pass
    ``drain=True`` to also clear the ring (periodic export loops)."""
    t = tracer if tracer is not None else _tracer.default_tracer()
    if spans is None:
        spans = t.drain() if drain else t.spans()
    events = to_trace_events(spans, pid=t.pid)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": "perf_counter_ns",
            "clock_origin_ns": t.clock_origin_ns,
            "wall_origin_s": t.wall_origin_s,
            "dropped_spans": t.dropped,
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


def load_chrome_trace(path: str) -> Dict:
    """Load an exported trace (round-trip helper used by tests/tools)."""
    with open(path) as f:
        return json.load(f)
