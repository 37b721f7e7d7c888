"""Drain plumbing shared by serving engines (counterpart of
``DrainableEngineBase`` in ``paddle_tpu/serving/engine.py``; hard kill,
admission pause, preemption guards and signal handlers are not ported
yet).

Subclasses call :meth:`_init_serving_base` in ``__init__``, own a
``BatchQueue`` in ``self._queue`` and run one worker thread that polls
:attr:`draining`.
"""
from __future__ import annotations

import threading
from typing import Optional

from ..core.monitor import StatRegistry


class DrainableEngineBase:
    def _init_serving_base(self, registry: Optional[StatRegistry],
                           stat_prefix: str):
        self._registry = registry if registry is not None else StatRegistry()
        self._prefix = stat_prefix
        self._draining = threading.Event()
        self._stopped = threading.Event()

    @property
    def registry(self) -> StatRegistry:
        return self._registry

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self):
        """Stop admission and let the worker flush the queue
        (non-blocking)."""
        self._draining.set()
        self._queue.close()

    def _stat_add(self, name: str, v):
        self._registry.add(f"{self._prefix}.{name}", v)

    def _stat_set(self, name: str, v):
        self._registry.set(f"{self._prefix}.{name}", v)

    def _stat_observe(self, name: str, v):
        self._registry.observe(f"{self._prefix}.{name}", v)
