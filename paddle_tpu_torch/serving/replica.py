"""Replica: one health-tracked serving worker (counterpart of
``paddle_tpu/serving/replica.py``).

A :class:`Replica` wraps one engine (the dynamic-batching
:class:`~paddle_tpu_torch.serving.engine.Engine` or the
:class:`~paddle_tpu_torch.serving.llm.LLMEngine`) plus what the
:class:`~paddle_tpu_torch.serving.router.Router` needs to route around
it:

* a lifecycle: STARTING -> HEALTHY -> DRAINING -> DEAD, and DEAD ->
  STARTING on :meth:`resurrect`;
* outstanding-request accounting (the router dispatches to the replica
  with the fewest requests in flight);
* a health verdict (:meth:`healthz`): the lifecycle state, the engine's
  drain flag, queue depth against a threshold, and an optional external
  ``health_source`` (the numerical sentinel's ``healthy``, say);
* a health-stamped boot: with ``checkpoint_root``, each (re)start
  records the :func:`~paddle_tpu_torch.incubate.checkpoint.sharded.
  newest_healthy_checkpoint` pick in :attr:`boot_checkpoint` *before* it
  calls the engine factory, so the factory restores exactly what the
  sentinel vouched for.

The factory is ``factory(replica) -> engine``: it reads
``replica.device`` (where the engine runs) and ``replica.boot_checkpoint``
and returns a started engine. The JAX package gives each replica a device
subset or a sub-mesh; the port runs its replicas on one card (they share
``device``, as the JAX package's share one device when it has fewer
devices than replicas), and a ``mesh`` (model-parallel replicas) is
the second slice of ROADMAP.md queue A10.

Lock discipline: every mutable attribute (``_state``, ``_engine``,
``_outstanding``, ``_dispatched``, ``_completed``, ``_restarts``,
``_unhealthy_reason``, ``_boot_checkpoint``, ``_paused``) is read and
written under ``self._lock``; engine calls (submit, drain, kill: they
take the engine's own locks) happen outside it.
"""
from __future__ import annotations

import errno
import os
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Callable, Optional

from ..core.device import DeviceLike, resolve_device
from ..utils.resilience import fault_injector
from .request import EngineDraining

#: lifecycle states (plain strings so /healthz payloads serialize as-is)
STARTING = "STARTING"
HEALTHY = "HEALTHY"
DRAINING = "DRAINING"
DEAD = "DEAD"


class Replica:
    """One engine worker + the router-facing health/accounting shell."""

    def __init__(self, replica_id: int,
                 engine_factory: Callable[["Replica"], object], *,
                 device: DeviceLike = None, mesh=None,
                 checkpoint_root: Optional[str] = None,
                 restart_budget=None,
                 unhealthy_queue_depth: Optional[int] = None,
                 health_source: Optional[Callable[[], bool]] = None,
                 registry=None, clock=time.monotonic,
                 recovery_cb: Optional[Callable[["Replica"], None]] = None):
        self.replica_id = int(replica_id)
        #: StatRegistry the engine factory should hand its engine, so all
        #: replicas of one router publish into one scrape (per-replica
        #: stat prefixes keep their namespaces apart — see LLMEngine.stats)
        self.registry = registry
        if mesh is not None:
            raise NotImplementedError(
                "a replica over a device mesh (model-parallel serving) is "
                "the second slice of ROADMAP.md queue A10; the port's "
                "replicas run on one card")
        #: the device the factory builds the engine on
        self.device = resolve_device(device)
        self.checkpoint_root = checkpoint_root
        self.restart_budget = restart_budget
        self.unhealthy_queue_depth = unhealthy_queue_depth
        self._health_source = health_source
        self._clock = clock
        self._factory = engine_factory
        self._lock = threading.Lock()
        self._state = STARTING
        self._engine = None
        self._outstanding = 0
        self._dispatched = 0
        self._completed = 0
        self._restarts = 0
        self._unhealthy_reason: Optional[str] = None
        self._boot_checkpoint: Optional[str] = None
        self._paused = False
        # zero-loss serving (docs/fault_tolerance.md): when set, every
        # engine this replica boots gets its crash-recovery journal
        # armed, and kill() invokes the callback so the router can
        # replay evacuated sequences onto survivors
        self._recovery_cb = recovery_cb
        #: snapshot records from the last kill() (id, phase, tokens) —
        #: what was in the engine at the moment it died
        self.last_kill_records: list = []
        self._boot()

    # -- boot / resurrect ----------------------------------------------------
    def _boot(self):
        """Pick the boot checkpoint, build the engine, go HEALTHY. Raises
        whatever the factory raises (first construction fails fast;
        :meth:`resurrect` catches)."""
        # chaos hook: `replica_boot` fires once per engine construction —
        # initial boot, resurrection, and autoscale-up all pass through
        # here, so one occurrence spec covers them all
        action = fault_injector().fire("replica_boot")
        if action == "fail":
            raise RuntimeError(
                f"fault injection: replica {self.replica_id} boot failed")
        if action == "disk_full":
            raise OSError(errno.ENOSPC,
                          f"fault injection: replica {self.replica_id} "
                          f"boot hit ENOSPC")
        if action == "slow_io":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SLOW_IO_S", "0.2")))
        ckpt = None
        if self.checkpoint_root is not None:
            from ..incubate.checkpoint.async_ckpt import cleanup_stale_staging
            from ..incubate.checkpoint.sharded import newest_healthy_checkpoint
            # a trainer killed mid-commit may have left *.tmp staging debris
            # next to the committed checkpoints; sweep it before the walk
            cleanup_stale_staging(self.checkpoint_root)
            ckpt = newest_healthy_checkpoint(self.checkpoint_root)
        with self._lock:
            self._boot_checkpoint = ckpt
            self._state = STARTING
        engine = self._factory(self)
        if self._recovery_cb is not None \
                and hasattr(engine, "enable_recovery"):
            # re-armed on EVERY boot: a resurrected engine instance is a
            # fresh object and must journal from its first tick
            engine.enable_recovery()
        with self._lock:
            self._engine = engine
            self._state = HEALTHY
            self._unhealthy_reason = None

    def resurrect(self, consume_budget: bool = True) -> bool:
        """Bring a DEAD replica back through a fresh health-stamped boot.

        With ``consume_budget`` (the default for direct callers), one
        restart is claimed from :attr:`restart_budget` first — False when
        the budget is spent. The router's health loop claims the budget
        itself (to schedule the backoff pause) and passes
        ``consume_budget=False``. A factory failure warns, leaves the
        replica DEAD, and returns False.
        """
        with self._lock:
            if self._state != DEAD:
                return False
        if consume_budget and self.restart_budget is not None \
                and not self.restart_budget.try_consume():
            return False
        try:
            self._boot()
        except Exception as e:
            warnings.warn(
                f"replica {self.replica_id} failed to resurrect: {e!r}")
            with self._lock:
                self._state = DEAD
            return False
        with self._lock:
            self._restarts += 1
        return True

    # -- dispatch ------------------------------------------------------------
    @property
    def engine(self):
        with self._lock:
            return self._engine

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    @property
    def admissible(self) -> bool:
        """May the router hand this replica a request right now?"""
        with self._lock:
            if self._state != HEALTHY or self._unhealthy_reason is not None \
                    or self._paused:
                return False
            engine = self._engine
        return engine is not None and not engine.draining

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    def pause(self):
        """Fleet control: stop router dispatch to this replica WITHOUT
        marking it unhealthy (the health sweep must not drain it) and
        WITHOUT touching the engine — the weight-swap probe talks to the
        engine directly while the replica is paused."""
        with self._lock:
            self._paused = True

    def resume(self):
        with self._lock:
            self._paused = False

    def kill(self, reason: str = "killed") -> bool:
        """Hard-kill (the in-process SIGKILL analog): the replica goes
        DEAD immediately. Queued work fails retryably with
        :class:`~paddle_tpu.serving.request.EngineKilled`; in-flight
        work is aborted — or, when the recovery callback is wired,
        evacuated and handed to the router for replay onto survivors
        (docs/fault_tolerance.md "Zero-loss serving"). The router's
        health sweep sees DEAD and schedules a budgeted resurrection,
        exactly as for a drained-out replica."""
        with self._lock:
            if self._state == DEAD:
                return False
            self._state = DEAD
            engine = self._engine
        if engine is not None:
            self.last_kill_records = engine.kill(
                f"replica {self.replica_id}: {reason}")
            if self._recovery_cb is not None:
                try:
                    self._recovery_cb(self)
                except Exception as e:  # noqa: BLE001 -- recovery is best-effort; the kill verdict stands either way
                    warnings.warn(
                        f"replica {self.replica_id} recovery callback "
                        f"failed: {e!r}")
        return True

    @property
    def boot_checkpoint(self) -> Optional[str]:
        """The checkpoint the current engine instance booted from (None
        when no ``checkpoint_root`` was configured or nothing survived the
        newest-healthy walk)."""
        with self._lock:
            return self._boot_checkpoint

    def submit(self, *args, **kwargs):
        """Forward to the engine's ``submit``, with outstanding-request
        accounting. Returns whatever the engine returns (a Future for the
        classifier engine, a GenerationRequest for the LLM engine)."""
        with self._lock:
            if self._state != HEALTHY or self._unhealthy_reason is not None \
                    or self._paused:
                raise EngineDraining(
                    f"replica {self.replica_id} is "
                    + ("paused" if self._paused and self._state == HEALTHY
                       else self._state)
                    + (f" ({self._unhealthy_reason})"
                       if self._unhealthy_reason else ""))
            engine = self._engine
        out = engine.submit(*args, **kwargs)
        fut = out if isinstance(out, Future) else out.future
        with self._lock:
            self._outstanding += 1
            self._dispatched += 1
        fut.add_done_callback(self._on_done)
        return out

    def _on_done(self, _fut):
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)
            self._completed += 1

    # -- health --------------------------------------------------------------
    def mark_unhealthy(self, reason: str):
        """External verdict (sentinel divergence, operator action): stop
        admitting; the router's next sweep drains this replica."""
        with self._lock:
            self._unhealthy_reason = str(reason)

    def queue_depth(self) -> int:
        engine = self.engine
        if engine is None:
            return 0
        try:
            return len(engine._queue)
        except Exception:
            return 0

    def healthz(self) -> dict:
        """The per-replica health verdict: state + every reason it is not
        serving (empty ``reasons`` == healthy)."""
        with self._lock:
            state = self._state
            reason = self._unhealthy_reason
            engine = self._engine
            outstanding = self._outstanding
            restarts = self._restarts
            boot = self._boot_checkpoint
            paused = self._paused
        reasons = []
        if state != HEALTHY:
            reasons.append(f"state={state}")
        if reason is not None:
            reasons.append(f"marked_unhealthy: {reason}")
        if engine is not None and engine.draining and state == HEALTHY:
            reasons.append("engine_draining")
        depth = self.queue_depth()
        if self.unhealthy_queue_depth is not None \
                and depth > self.unhealthy_queue_depth:
            reasons.append(
                f"queue_depth {depth} > {self.unhealthy_queue_depth}")
        if self._health_source is not None:
            try:
                if not self._health_source():
                    reasons.append("health_source")
            except Exception as e:
                reasons.append(f"health_source_error: {e!r}")
        # NB: paused is deliberately NOT a reason — the health sweep drains
        # replicas whose healthz goes unhealthy, and a paused replica
        # (autoscale park / mid-swap) must stay bootable, not get drained
        return {
            "replica": self.replica_id,
            "state": state,
            "healthy": not reasons,
            "paused": paused,
            "reasons": reasons,
            "queue_depth": depth,
            "outstanding": outstanding,
            "restarts": restarts,
            "boot_checkpoint": boot,
        }

    # -- drain ---------------------------------------------------------------
    def begin_drain(self):
        """Stop admission and start the engine's graceful drain
        (non-blocking; :meth:`poll_drained` observes completion)."""
        with self._lock:
            if self._state in (DRAINING, DEAD):
                return
            self._state = DRAINING
            engine = self._engine
        if engine is not None:
            engine.begin_drain()

    def poll_drained(self) -> bool:
        """True once the engine worker has stopped; flips DRAINING → DEAD
        on first observation."""
        with self._lock:
            if self._state == DEAD:
                return True
            if self._state != DRAINING:
                return False
            engine = self._engine
        if engine is None or engine._stopped.is_set():
            with self._lock:
                self._state = DEAD
            return True
        return False

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Blocking drain: begin + wait for the engine worker to stop."""
        self.begin_drain()
        engine = self.engine
        if engine is not None:
            engine._stopped.wait(timeout)
        return self.poll_drained()

    def stats(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "paused": self._paused,
                "outstanding": self._outstanding,
                "dispatched": self._dispatched,
                "completed": self._completed,
                "restarts": self._restarts,
                "boot_checkpoint": self._boot_checkpoint,
            }
        out["queue_depth"] = self.queue_depth()
        return out

    def __repr__(self):
        return (f"Replica(id={self.replica_id}, state={self.state}, "
                f"outstanding={self.outstanding})")
