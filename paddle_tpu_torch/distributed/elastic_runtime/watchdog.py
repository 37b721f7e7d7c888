"""StepWatchdog: convert a hung step into a bounded-time exit 121
(counterpart of ``paddle_tpu/distributed/elastic_runtime/watchdog.py``).

When a peer dies mid-collective, the survivors' collectives never
complete and the job wedges with no exception to catch. The training
loop *arms* the watchdog at the start of every guarded step and
*disarms* it at the end; a deadline thread notices an armed step that
overstayed ``deadline_s``, records a flight event, dumps the flight
recorder and exits with
:data:`~paddle_tpu_torch.distributed.elastic.HOST_LOST_EXIT_CODE` (121),
which a cohort supervisor reads as "a peer is gone". Step-path cost: two
monotonic-clock reads and two short lock sections a step, no device
work. ``FaultToleranceCallback`` and ``TrainEpochRange`` arm it, from
``PADDLE_TPU_STEP_DEADLINE_S`` (:func:`maybe_auto_watchdog`) or given.

Fault sites fired inside :meth:`StepWatchdog.arm`: ``host_kill:N:crash``
(a hard exit on the Nth guarded step) and ``collective_hang:N:hang``
(the Nth guarded step blocks ``PADDLE_TPU_FAULT_HANG_S`` seconds inside
the armed window, so the deadline turns it into exit 121).
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from ..elastic import HOST_LOST_EXIT_CODE  # noqa: F401  (re-exported)
from ...utils.resilience import fault_injector
from .heartbeat import cohort_generation

#: env var the cohort supervisor sets in every child: guarded-step deadline
#: in seconds; presence auto-arms a process-wide StepWatchdog (see
#: maybe_auto_watchdog). 0/unset = watchdog off.
STEP_DEADLINE_VAR = "PADDLE_TPU_STEP_DEADLINE_S"

HANG_SECONDS = float(os.environ.get("PADDLE_TPU_FAULT_HANG_S", "3600"))


class StepWatchdog:
    """Deadline thread around guarded train steps.

    ::

        wd = StepWatchdog(deadline_s=60)
        for step, batch in enumerate(loader):
            with wd.guard(step):
                loss = train_step(batch)   # hangs forever? exit 121 at 60s

    ``on_timeout`` (tests) replaces the terminal dump+exit; ``exit_fn`` is
    injectable for the same reason. ``heartbeat`` is an optional beacon
    sender (ROADMAP A10's second slice) that gets ``notify_step`` with each disarmed
    step's wall-time.
    """

    def __init__(self, deadline_s: float,
                 on_timeout: Optional[Callable[[Optional[int], float],
                                               None]] = None,
                 exit_fn: Callable[[int], None] = os._exit,
                 heartbeat=None, clock=time.monotonic,
                 poll_s: Optional[float] = None):
        self.deadline_s = float(deadline_s)
        if self.deadline_s <= 0:
            raise ValueError(
                f"StepWatchdog deadline must be positive, got {deadline_s}"
                f" (omit the watchdog instead of arming a zero deadline)")
        self._on_timeout = on_timeout
        self._exit_fn = exit_fn
        self.heartbeat = heartbeat
        self._clock = clock
        self._poll_s = (max(0.005, min(0.25, self.deadline_s / 8.0))
                        if poll_s is None else float(poll_s))
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._step: Optional[int] = None
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- step-path API ------------------------------------------------------
    def arm(self, step: Optional[int] = None):
        """Start the deadline for one guarded step. Fires the ``host_kill``
        and ``collective_hang`` chaos sites (the latter *after* arming, so
        an injected hang is covered by the deadline it exists to test)."""
        # fire the chaos sites only when some spec is armed at all — fire()
        # itself is cheap, but arm() runs once per train step and the
        # common case (no injection) should cost one bool check
        inj = fault_injector()
        chaos = inj.armed()
        if chaos:
            inj.fire("host_kill")
        with self._lock:
            self._armed_at = self._clock()
            self._step = step
        self._ensure_thread()
        if chaos and inj.fire("collective_hang") == "hang":
            time.sleep(HANG_SECONDS)

    def disarm(self) -> Optional[float]:
        """End the guarded step; returns its wall-time (None if unarmed)."""
        with self._lock:
            if self._armed_at is None:
                return None
            elapsed = self._clock() - self._armed_at
            self._armed_at = None
            step = self._step
        if self.heartbeat is not None and step is not None:
            self.heartbeat.notify_step(step, elapsed)
        return elapsed

    @contextmanager
    def guard(self, step: Optional[int] = None):
        self.arm(step)
        try:
            yield self
        finally:
            self.disarm()

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed_at is not None

    @property
    def fired(self) -> bool:
        with self._lock:
            return self._fired

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- deadline thread ----------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="step-watchdog", daemon=True)
            self._thread.start()

    def _watch(self):
        while not self._stop.wait(self._poll_s):
            with self._lock:
                armed_at = self._armed_at
                step = self._step
                if armed_at is None:
                    continue
                elapsed = self._clock() - armed_at
                if elapsed <= self.deadline_s:
                    continue
                self._fired = True
                self._armed_at = None
            self._fire(step, elapsed)
            return

    def _fire(self, step: Optional[int], elapsed: float):
        """Deadline blown: the step wedged (peer death mid-collective is
        the expected cause). Record + dump the flight timeline, then exit
        with the reserved host-lost code so the cohort supervisor re-forms
        the world instead of respawning just this rank."""
        from ...observability import flight as _flight
        gen = cohort_generation()
        _flight.record_event(
            "distributed.watchdog_fired",
            {"step": step, "gen": gen, "elapsed_s": round(elapsed, 3),
             "deadline_s": self.deadline_s})
        if self._on_timeout is not None:
            self._on_timeout(step, elapsed)
            return
        # unconditional dump (not dump_if_armed): the process is about to
        # exit 121 and this file is the only record of where it wedged —
        # last events, last spans, the hung step, the cohort generation
        _flight.dump(f"host_lost_watchdog_step_{step}_gen_{gen}")
        self._exit_fn(HOST_LOST_EXIT_CODE)


_AUTO_WATCHDOG: list = []


def maybe_auto_watchdog(watchdog: Optional[StepWatchdog] = None
                        ) -> Optional[StepWatchdog]:
    """Return ``watchdog``, or the process-wide auto-armed one when the
    cohort supervisor set :data:`STEP_DEADLINE_VAR` (>0), else None — the
    same wire-through-env pattern as
    :func:`~paddle_tpu.distributed.elastic.maybe_auto_guard`."""
    if watchdog is not None:
        return watchdog
    if _AUTO_WATCHDOG:
        return _AUTO_WATCHDOG[0]
    try:
        deadline = float(os.environ.get(STEP_DEADLINE_VAR, "0") or "0")
    except ValueError:
        return None
    if deadline <= 0:
        return None
    from .heartbeat import maybe_auto_sender
    wd = StepWatchdog(deadline, heartbeat=maybe_auto_sender())
    _AUTO_WATCHDOG.append(wd)
    return wd


def _reset_auto_watchdog_for_tests():
    while _AUTO_WATCHDOG:
        _AUTO_WATCHDOG.pop().stop()
