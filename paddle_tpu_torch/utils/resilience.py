"""Retry with backoff, deadlines, and deterministic fault injection
(counterpart of ``paddle_tpu/utils/resilience.py``).

The substrate of the port's fault tolerance: transient-error retry with
exponential backoff and jitter, wall-clock deadlines, and the
environment-driven :class:`FaultInjector` (``PADDLE_TPU_FAULT_SPEC``),
which lets tests kill a process or corrupt a write at an exact,
reproducible point. The spec grammar, the sites, the actions and the
crash exit code are the JAX package's, so a deployment's fault specs
carry over.

Standard library only: the launcher's supervisor and the pre-device
bootstrap import it, and neither may touch torch or a device.
"""
from __future__ import annotations

import functools
import os
import random
import sys
import time
from typing import Callable, Optional, Tuple, Type


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` is the last exception."""


class DeadlineExceeded(TimeoutError):
    pass


class FaultInjected(RuntimeError):
    """Raised by FaultInjector for the ``raise`` action."""


#: exit code of a FaultInjector ``crash`` action — a simulated hard crash;
#: the elastic supervisor counts it against the restart budget.
FAULT_CRASH_EXIT_CODE = 43


class Deadline:
    """A wall-clock budget. ``clock`` is injectable so tests never sleep."""

    def __init__(self, seconds: Optional[float], clock=time.monotonic):
        self._clock = clock
        self.seconds = None if seconds is None else float(seconds)
        self._t0 = clock()

    @classmethod
    def from_env(cls, var: str, default: Optional[float] = None, **kw):
        raw = os.environ.get(var)
        return cls(float(raw) if raw not in (None, "") else default, **kw)

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation"):
        if self.expired():
            raise DeadlineExceeded(
                f"{what} exceeded its {self.seconds}s deadline")


def retry_call(fn: Callable, args=(), kwargs=None, *,
               max_attempts: int = 3,
               backoff: float = 0.5,
               multiplier: float = 2.0,
               max_backoff: float = 30.0,
               jitter: float = 0.1,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               deadline: Optional[Deadline] = None,
               sleep=time.sleep,
               rng=random.random,
               on_retry: Optional[Callable] = None):
    """Call ``fn`` with exponential backoff + jitter between failures.

    Attempts stop at ``max_attempts`` (or when ``deadline`` expires, if one
    is given) and the last exception is re-raised wrapped in
    :class:`RetryError`. ``sleep``/``rng`` are injectable so unit tests run
    with a fake clock and deterministic jitter.
    """
    kwargs = kwargs or {}
    delay = backoff
    last = None
    for attempt in range(1, max(1, int(max_attempts)) + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # noqa: PERF203 — the whole point
            last = e
            out_of_time = deadline is not None and deadline.expired()
            if attempt >= max_attempts or out_of_time:
                break
            pause = delay * (1.0 + jitter * (2.0 * rng() - 1.0))
            if deadline is not None:
                pause = min(pause, max(0.0, deadline.remaining()))
            if on_retry is not None:
                on_retry(attempt, e, pause)
            sleep(pause)
            delay = min(delay * multiplier, max_backoff)
    raise RetryError(
        f"{getattr(fn, '__name__', fn)} failed after {attempt} "
        f"attempt(s): {last!r}") from last


def retry(max_attempts: int = 3, backoff: float = 0.5, multiplier: float = 2.0,
          max_backoff: float = 30.0, jitter: float = 0.1,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          sleep=time.sleep, rng=random.random,
          on_retry: Optional[Callable] = None):
    """Decorator form of :func:`retry_call`::

        @retry(max_attempts=3, backoff=0.5)
        def fetch(): ...
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(
                fn, args, kwargs, max_attempts=max_attempts, backoff=backoff,
                multiplier=multiplier, max_backoff=max_backoff, jitter=jitter,
                retry_on=retry_on, sleep=sleep, rng=rng, on_retry=on_retry)
        return wrapper
    return decorator


# -- fault injection ----------------------------------------------------------

class FaultInjector:
    """Deterministic, env-driven fault injection for resilience tests.

    Spec grammar (``PADDLE_TPU_FAULT_SPEC``)::

        spec     := rule ("," rule)*
        rule     := site ":" occurrence ":" action
        site     := identifier           # e.g. epoch, step, save, load
        occurrence := positive integer   # 1-based count of fire(site) calls
        action   := "crash" | "raise" | anything  # others returned verbatim

    Example: ``epoch:3:crash,load:1:corrupt`` — hard-exit the process (code
    :data:`FAULT_CRASH_EXIT_CODE`) on the third ``fire("epoch")`` of this
    process, and hand the string ``"corrupt"`` back to the first
    ``fire("load")`` caller (the checkpoint loader corrupts a shard file and
    then proceeds, so checksum verification can be exercised end to end).

    The sites and the actions their call sites interpret (``corrupt``
    at ``save``/``load``, ``nan`` at ``grads``/``loss``, the checkpoint
    pipeline's, the serving fleet's and the host-loss sites) are the JAX
    package's; its ``docs/fault_tolerance.md`` has the catalog. Their
    call sites come with the port's checkpoints, sentinel, fleet and
    elastic runtime (ROADMAP.md queue A, slices 22-24 and A10).

    Counters are per-process: a restarted trainer starts counting from zero
    again, which is exactly what makes "crash once, then succeed" scenarios
    expressible with a single rule. Duplicate ``site:occurrence`` pairs are
    rejected — only one action can win a given firing, and silently keeping
    the first (or last) makes the loser impossible to debug.
    """

    def __init__(self, spec: Optional[str] = None):
        if spec is None:
            spec = os.environ.get("PADDLE_TPU_FAULT_SPEC", "")
        self._rules = {}   # site -> list of (occurrence, action)
        self._counts = {}  # site -> fires so far
        for rule in spec.split(","):
            rule = rule.strip()
            if not rule:
                continue
            parts = [p.strip() for p in rule.split(":")]
            if len(parts) != 3 or not all(parts) or not parts[1].isdigit():
                raise ValueError(
                    f"bad PADDLE_TPU_FAULT_SPEC rule {rule!r}; expected "
                    f"site:occurrence:action (e.g. epoch:2:crash)")
            site, occ, action = parts[0], int(parts[1]), parts[2]
            if occ < 1:
                raise ValueError(
                    f"bad PADDLE_TPU_FAULT_SPEC rule {rule!r}: occurrence "
                    f"is 1-based (the first fire is 1); 0 would never fire")
            if any(o == occ for o, _ in self._rules.get(site, ())):
                raise ValueError(
                    f"duplicate PADDLE_TPU_FAULT_SPEC rule for "
                    f"{site}:{occ}: each site:occurrence pair may appear "
                    f"only once")
            self._rules.setdefault(site, []).append((occ, action))

    def armed(self, site: Optional[str] = None) -> bool:
        if site is None:
            return bool(self._rules)
        return site in self._rules

    def fire(self, site: str) -> Optional[str]:
        """Count one occurrence of ``site``; execute/return a matching rule.

        ``crash`` → ``os._exit(FAULT_CRASH_EXIT_CODE)`` (no cleanup, like a
        real kill). ``raise`` → raises :class:`FaultInjected`. Any other
        action string is returned for the call site to interpret
        (e.g. ``corrupt``). Returns None when no rule matches.
        """
        if site not in self._rules:
            return None
        self._counts[site] = self._counts.get(site, 0) + 1
        n = self._counts[site]
        for occ, action in self._rules[site]:
            if occ != n:
                continue
            if action in ("crash", "kill_during_commit"):
                sys.stderr.write(
                    f"[FaultInjector] {action} at {site}:{n}\n")
                sys.stderr.flush()
                os._exit(FAULT_CRASH_EXIT_CODE)
            if action == "raise":
                raise FaultInjected(f"injected fault at {site}:{n}")
            return action
        return None


_INJECTOR: Optional[FaultInjector] = None


def fault_injector() -> FaultInjector:
    """The process-wide injector, parsed once from the environment."""
    global _INJECTOR
    if _INJECTOR is None:
        _INJECTOR = FaultInjector()
    return _INJECTOR


def _reset_fault_injector_for_tests():
    global _INJECTOR
    _INJECTOR = None
