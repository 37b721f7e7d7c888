"""Preemption-aware elastic training support (counterpart of
``paddle_tpu/distributed/elastic.py``).

The trainer's half of the elastic contract. A :class:`PreemptionGuard`
arms SIGTERM/SIGINT so a training loop can observe that the platform
wants the process gone, commit a final checkpoint and exit with
:data:`PREEMPTION_EXIT_CODE`, which the supervisor restarts without
charging its restart budget. :class:`ChainedSignalHandler` lets several
subsystems (the guard, the serving engines' drain, the flight
recorder's dump) share one signal without clobbering each other.
:class:`RestartBudget` is the capped, jittered restart accounting the
supervisor and the serving router share. The exit codes and the
``PADDLE_TPU_ELASTIC`` variable are the JAX package's.

Single-process code on the standard library alone: the guard must work
before any device is touched. The launcher and its ``--elastic``
supervisor are ``distributed/launch.py``; the cohort supervisor is the
second slice of ROADMAP.md queue A10.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
from typing import Callable, Optional, Sequence

#: Reserved exit code for "drained after preemption; resume me". Chosen
#: outside the shell (126-128) and signal (128+N) ranges and unlikely to
#: collide with user scripts. The elastic supervisor restarts this rank
#: without counting it against --max_restarts.
PREEMPTION_EXIT_CODE = 117

#: Exit code the numerical-anomaly sentinel uses for a *deterministic*
#: divergence (``halt`` rung). Unlike a preemption (free restart) or a crash
#: (budgeted restart), a diverged run would diverge again from the same
#: state, so the supervisor tears the job down instead of respawning.
DIVERGENCE_EXIT_CODE = 119

#: Exit code the StepWatchdog (elastic_runtime.watchdog) uses when a guarded
#: train step blows its deadline — the signature of a peer host dying
#: mid-collective (the survivors don't crash, they stall forever inside the
#: allreduce). The cohort supervisor treats it as "a peer is gone": it tears
#: down ALL local workers, bumps the cohort generation, and re-forms the
#: world, instead of respawning the one rank that happened to notice.
HOST_LOST_EXIT_CODE = 121

#: Env var the elastic supervisor sets in every child so training loops can
#: auto-arm a PreemptionGuard without code changes.
ELASTIC_ENV_VAR = "PADDLE_TPU_ELASTIC"

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def under_elastic_supervisor() -> bool:
    return bool(os.environ.get(ELASTIC_ENV_VAR))


class ChainedSignalHandler:
    """Install a callback on signals WITHOUT clobbering what was there.

    Several subsystems legitimately want the same signals — the elastic
    :class:`PreemptionGuard` arms SIGTERM for checkpoint-then-exit, and the
    serving ``Engine`` arms SIGTERM for graceful drain. A plain
    ``signal.signal`` call from the second one silently disables the first.
    This helper saves the previous handler at install time and invokes it
    *after* the callback, so every interested party observes the signal;
    :meth:`uninstall` restores the saved handlers.

    Installation is a no-op off the main thread (CPython only delivers
    signals to the main thread, and ``signal.signal`` raises elsewhere).
    """

    def __init__(self, callback: Callable[[int, object], None],
                 signals: Sequence[int] = _DEFAULT_SIGNALS):
        self._callback = callback
        self._signals = tuple(signals)
        self._prev = {}
        self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def install(self):
        if (self._installed
                or threading.current_thread() is not threading.main_thread()):
            return self
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        """Restore the handlers saved at install time — but only where we
        are still the current handler. If a third party re-registered a
        signal after our install, blindly restoring would silently disable
        *them* (the exact clobbering this class exists to prevent), so
        their handler is left in place."""
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            # == not `is`: each `self._on_signal` access builds a fresh
            # bound method; equality compares __self__ and __func__
            if signal.getsignal(sig) == self._on_signal:
                signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame):
        self._callback(signum, frame)
        prev = self._prev.get(signum)
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)


class PreemptionGuard:
    """Signal-armed preemption flag for training loops.

    ::

        guard = PreemptionGuard()          # arms SIGTERM/SIGINT
        for epoch in epochs:
            train_one_epoch(...)
            guard.exit_if_preempted(save_fn=lambda: ckpt.save(epoch))

    The handler only sets a flag (async-signal-safe); all real work — the
    final checkpoint, the exit — happens at the next poll point in the
    training loop, so a preemption can never tear a half-written shard.
    Previous handlers are chained, and :meth:`uninstall` restores them.
    """

    def __init__(self, signals: Sequence[int] = _DEFAULT_SIGNALS,
                 install: bool = True):
        self._event = threading.Event()
        self._chain = ChainedSignalHandler(self._handler, signals)
        if install:
            self.install()

    # -- signal plumbing ----------------------------------------------------
    def install(self):
        self._chain.install()
        return self

    def uninstall(self):
        self._chain.uninstall()

    @property
    def _installed(self) -> bool:  # kept for older callers/tests
        return self._chain.installed

    def _handler(self, signum, frame):
        self._event.set()

    # -- polling API --------------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def should_stop(self) -> bool:
        return self.preempted

    def preempt(self):
        """Mark preemption programmatically (tests, cloud-notice pollers)."""
        self._event.set()

    def exit_if_preempted(self, save_fn: Optional[Callable[[], None]] = None,
                          code: int = PREEMPTION_EXIT_CODE):
        """At a safe point: if preempted, run ``save_fn`` (the final
        checkpoint commit) and exit with the reserved resume code."""
        if not self.preempted:
            return
        if save_fn is not None:
            save_fn()
        self.uninstall()
        sys.exit(code)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


class RestartBudget:
    """Thread-safe restart accounting shared by the elastic supervisor and
    the serving replica router.

    One consumer (the supervisor) respawns a whole training job; the other
    (the router's health loop) resurrects individual replica workers. Both
    want the same semantics: a hard cap on non-preemption restarts plus
    exponential backoff with ±20% jitter, capped — so thundering-herd
    resurrections after a shared fault are decorrelated. ``try_consume``
    atomically claims one restart (False when exhausted); ``pause`` derives
    the backoff from how many restarts have been consumed so far.
    """

    def __init__(self, max_restarts: int = 3, backoff: float = 1.0,
                 cap: float = 30.0, rng=None):
        import random as _random
        self.max_restarts = int(max_restarts)
        self.backoff0 = float(backoff)
        self.cap = float(cap)
        self._rng = rng if rng is not None else _random.Random()
        self._lock = threading.Lock()
        self._used = 0

    @property
    def used(self) -> int:
        with self._lock:
            return self._used

    @property
    def remaining(self) -> int:
        with self._lock:
            return max(0, self.max_restarts - self._used)

    def try_consume(self) -> bool:
        """Atomically claim one restart; False when the budget is spent."""
        with self._lock:
            if self._used >= self.max_restarts:
                return False
            self._used += 1
            return True

    def pause(self) -> float:
        """Backoff for the restart just consumed: ``backoff * 2**(used-1)``
        capped, with ±20% jitter (same curve the supervisor always used)."""
        with self._lock:
            used = self._used
        base = min(self.backoff0 * (2 ** max(0, used - 1)), self.cap)
        return base * (1.0 + 0.2 * (2.0 * self._rng.random() - 1.0))

    def __repr__(self):
        return (f"RestartBudget(used={self.used}/{self.max_restarts}, "
                f"backoff={self.backoff0}, cap={self.cap})")


def maybe_auto_guard(guard: Optional[PreemptionGuard]) -> Optional[PreemptionGuard]:
    """Return ``guard``, or a fresh one when running under the elastic
    supervisor (which sets :data:`ELASTIC_ENV_VAR` in every child)."""
    if guard is not None:
        return guard
    if under_elastic_supervisor():
        return PreemptionGuard()
    return None
