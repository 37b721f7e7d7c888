"""paddle_tpu_torch.observability: runtime telemetry (counterpart of
``paddle_tpu/observability``), one substrate across training, serving
and LLM decode:

* :mod:`.tracer`: the span tracer (``with span("train/step")``) with a
  zero-allocation disabled path; Chrome/Perfetto export in
  :mod:`.export`.
* :mod:`.metrics`: Prometheus text of a ``StatRegistry``.
* :mod:`.stepmeter`: MFU and FLOPs per step from ``FlopCounterMode`` and
  the hand-written kernels' own counts, over a measured wall time
  (``train.mfu``, ``serving.llm.mfu``).
* :mod:`.flight`: the crash flight recorder.

``enable()`` turns it all on (span recording and an armed flight
recorder); an instrumented call site costs one indexed load while it is
off.
"""
from __future__ import annotations

from typing import Optional

from . import export, flight, metrics, stepmeter, tracer  # noqa: F401
from .export import export_chrome_trace, load_chrome_trace  # noqa: F401
from .flight import (FlightRecorder, default_recorder,  # noqa: F401
                     record_event)
from .metrics import render_prometheus  # noqa: F401
from .stepmeter import StepMeter, compiled_flops  # noqa: F401
from .tracer import (SpanTracer, default_tracer, is_enabled,  # noqa: F401
                     span)


def enable(capacity: Optional[int] = None):
    """Enable span recording and arm the flight recorder."""
    tracer.enable(capacity)
    flight.arm()


def disable():
    """Stop span recording and disarm crash-path dumps (the recorded ring
    and flight events are kept until ``tracer.default_tracer().clear()``)."""
    tracer.disable()
    flight.disarm()
