"""Serving error taxonomy (counterpart of ``paddle_tpu/serving/request.py``,
the part the LLM engine uses). Deadlines are
:class:`~paddle_tpu_torch.utils.resilience.Deadline`, re-exported here."""
from __future__ import annotations

from ..utils.resilience import Deadline, DeadlineExceeded  # noqa: F401


class ServingError(RuntimeError):
    """Base class for serving-side rejections."""


class QueueFull(ServingError):
    """Admission control rejected the request: the queue is at capacity and
    the configured backpressure wait elapsed."""


class EngineDraining(ServingError):
    """The engine is draining; no new requests are admitted."""


class RequestTooLarge(ServingError):
    """The request does not fit the engine (prompt longer than the largest
    prefill bucket, or more pages than the pool holds)."""
