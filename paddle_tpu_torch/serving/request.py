"""Request objects and the serving error taxonomy (counterpart of
``paddle_tpu/serving/request.py``). A request of the dynamic-batching
:class:`~.engine.Engine` is a list of numpy input arrays whose leading
axis is the row (batch) dimension; the engine resolves its
``concurrent.futures.Future`` with the list of output arrays (or an
exception). Deadlines are
:class:`~paddle_tpu_torch.utils.resilience.Deadline`, re-exported here.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np

from ..utils.resilience import Deadline, DeadlineExceeded  # noqa: F401

_REQ_IDS = itertools.count(1)


class ServingError(RuntimeError):
    """Base class for serving-side rejections."""


class QueueFull(ServingError):
    """Admission control rejected the request: the queue is at capacity and
    the configured backpressure wait elapsed."""


class EngineDraining(ServingError):
    """The engine is draining; no new requests are admitted."""


class RequestTooLarge(ServingError):
    """The request does not fit the engine (rows beyond the largest batch
    bucket with ``oversize_policy="reject"``, a prompt longer than the
    largest prefill bucket, or more pages than the pool holds)."""


class EngineKilled(ServingError):
    """The engine was hard-killed (the in-process analog of a replica
    SIGKILL). Queued and in-flight requests fail with this error;
    retryable, they never produced partial output."""


class InferenceRequest:
    """One queued inference call: inputs + deadline + result future."""

    __slots__ = ("req_id", "inputs", "nrows", "deadline", "future",
                 "t_enqueue")

    def __init__(self, inputs: Sequence[np.ndarray],
                 deadline: Optional[Deadline] = None,
                 clock=time.monotonic):
        if not inputs:
            raise ValueError("request needs at least one input array")
        arrays = [np.asarray(a) for a in inputs]
        rows = {a.shape[0] for a in arrays if a.ndim > 0}
        if len(rows) != 1:
            raise ValueError(
                f"all inputs must share the leading (row) dimension; "
                f"got shapes {[a.shape for a in arrays]}")
        self.req_id = next(_REQ_IDS)
        self.inputs: List[np.ndarray] = arrays
        self.nrows = arrays[0].shape[0]
        self.deadline = deadline
        self.future: Future = Future()
        self.t_enqueue = clock()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired()

    def seq_len(self) -> Optional[int]:
        """Length of axis 1 of the first input, when it has one."""
        a = self.inputs[0]
        return int(a.shape[1]) if a.ndim >= 2 else None

    def fail(self, exc: BaseException) -> bool:
        """Resolve the future with ``exc`` (idempotent)."""
        if self.future.done():
            return False
        self.future.set_exception(exc)
        return True

    def fail_expired(self) -> bool:
        return self.fail(DeadlineExceeded(
            f"request {self.req_id} ({self.nrows} rows) exceeded its "
            f"{self.deadline.seconds}s deadline before dispatch"))
