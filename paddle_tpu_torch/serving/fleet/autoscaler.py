"""SLO-aware autoscaler: the fleet's capacity controller (counterpart of
``paddle_tpu/serving/fleet/autoscaler.py``; the same decision loop, the
same decision records and stats, and three timings the reference lacks).

One controller thread polls :meth:`Router.fleet_snapshot` every
``interval_s`` and compares it against the declared :class:`SLO`. The
loop is deliberately boring — a hysteresis window on both sides of the
decision plus a cooldown after every action, because serving load is
bursty and a controller that reacts to single-tick spikes oscillates:

* **breach** (any of: fleet p95 above ``slo.p95_ms``, total queue depth
  above ``slo.max_queue``, or requests rejected with no admissible
  replica since the last tick) for ``breach_ticks`` consecutive ticks →
  scale UP by unparking the lowest-id parked replica. The unpark goes
  through the Router's budgeted boot path, so a scale-up is a counted
  resurrection on the same RestartBudget the health loop uses. On the
  port a boot captures the replica's CUDA graphs, which takes seconds
  beside a decoding sibling; the controller thread waits for it.
* **calm** (no breach) for ``calm_ticks`` consecutive ticks with more
  than ``slo.min_replicas`` active → scale DOWN by parking the
  least-loaded active replica. On fleets with live sequence migration
  (paged LLM replicas) the park is immediate — in-flight sequences move
  to siblings with their KV pages and keep streaming; otherwise the park
  is a graceful drain and in-flight work finishes in place.

The controller never creates or destroys replicas — the Router owns
``max_replicas`` shells for its whole life and the autoscaler only moves
them between parked and serving. All reads are host-side registry and
accounting snapshots; the request path never waits on the controller.

Stats the reference lacks (histograms under ``stat_prefix``):
``breach_to_up_ms``, from the first tick of a breach run to the unparked
replica admitting (the unpark returned booted); ``unpark_ms``, the
unpark call alone; ``park_ms``, a scale-down's park call.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

from ...core import monitor as _mon
from ...observability import flight as _flight
from ...observability import tracer as _otrace

__all__ = ["SLO", "AutoscalerConfig", "Autoscaler"]


class SLO:
    """The service-level objective the autoscaler defends."""

    def __init__(self, p95_ms: float = 500.0, max_queue: int = 32,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        self.p95_ms = float(p95_ms)
        self.max_queue = int(max_queue)
        self.min_replicas = int(min_replicas)
        self.max_replicas = max_replicas

    def __repr__(self):
        return (f"SLO(p95_ms={self.p95_ms}, max_queue={self.max_queue}, "
                f"replicas=[{self.min_replicas}, {self.max_replicas}])")


class AutoscalerConfig:
    """Controller tunables (hysteresis, cadence, cooldown)."""

    def __init__(self, interval_s: float = 0.5, breach_ticks: int = 2,
                 calm_ticks: int = 5, cooldown_s: float = 2.0,
                 start_at_min: bool = True,
                 stat_prefix: str = "fleet.autoscale"):
        if breach_ticks < 1 or calm_ticks < 1:
            raise ValueError("breach_ticks and calm_ticks must be >= 1")
        self.interval_s = float(interval_s)
        self.breach_ticks = int(breach_ticks)
        self.calm_ticks = int(calm_ticks)
        self.cooldown_s = float(cooldown_s)
        # park down to min_replicas on start(): the Router boots every
        # shell, and serving the baseline load from min keeps the spare
        # capacity parked (its programs captured once) instead of idling
        # in the path
        self.start_at_min = bool(start_at_min)
        self.stat_prefix = stat_prefix


class Autoscaler:
    """Scale a :class:`~paddle_tpu_torch.serving.router.Router` between
    ``slo.min_replicas`` and ``slo.max_replicas`` (default: all shells).

    ``start()`` runs the controller thread; :meth:`tick` is public so
    tests and the replay harness can drive the decision loop
    deterministically without waiting out wall-clock intervals.
    """

    def __init__(self, router, slo: SLO,
                 config: Optional[AutoscalerConfig] = None,
                 registry: Optional[_mon.StatRegistry] = None,
                 clock=time.monotonic):
        self.router = router
        self.slo = slo
        self.config = config or AutoscalerConfig()
        self._registry = registry if registry is not None else router.registry
        self._prefix = self.config.stat_prefix
        self._clock = clock
        n = len(router.replicas)
        if slo.max_replicas is None:
            slo.max_replicas = n
        if slo.max_replicas > n:
            raise ValueError(
                f"slo.max_replicas={slo.max_replicas} exceeds the router's "
                f"{n} replica shells (the autoscaler never creates "
                f"replicas, it only parks/unparks the ones the Router "
                f"booted)")
        self._breach_run = 0          # controller-thread-only
        self._calm_run = 0
        self._breach_t0 = 0.0         # clock at the breach run's first tick
        self._cooldown_until = 0.0
        self._last_rejects = 0.0
        self._last_completed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        if self.config.start_at_min:
            self._park_to_min()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-fleet-autoscaler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:
                # the controller must outlive a bad tick (a replica mid-
                # death can make snapshot reads race); count, warn, go on
                self._registry.add(f"{self._prefix}.tick_errors", 1)
                warnings.warn(f"autoscaler tick failed: {e!r}")
            self._stop.wait(self.config.interval_s)

    def _park_to_min(self):
        """Initial descent to min_replicas: park the highest-id active
        replicas so the lowest ids keep serving (matching unpark order)."""
        active = [x["replica"] for x in
                  self.router.fleet_snapshot()["replicas"]
                  if not x["parked"]]
        for rid in sorted(active, reverse=True):
            if len(active) <= self.slo.min_replicas:
                break
            self.router.park(rid)
            active.remove(rid)

    # -- the decision loop ---------------------------------------------------
    def tick(self) -> dict:
        """One controller decision: observe → classify → maybe act.
        Returns the decision record (also flight-logged on any action)."""
        with _otrace.span("fleet/autoscale_tick"):
            return self._tick_inner()

    def _tick_inner(self) -> dict:
        cfg, slo = self.config, self.slo
        now = self._clock()
        snap = self.router.fleet_snapshot()
        active = snap["active_replicas"]
        rejects = snap["rejected_no_replica"]
        reject_delta = max(0.0, rejects - self._last_rejects)
        self._last_rejects = rejects
        # latency samples live in a bounded reservoir that only refreshes
        # with traffic: a p95 reading is only evidence of a CURRENT breach
        # if requests completed since the last tick (the max() keeps the
        # watermark monotone across a dead replica's engine teardown)
        completed_delta = max(0, snap["completed"] - self._last_completed)
        self._last_completed = max(self._last_completed, snap["completed"])
        reasons = []
        if completed_delta > 0 and snap["p95_ms"] > slo.p95_ms:
            reasons.append(f"p95 {snap['p95_ms']:.1f}ms > {slo.p95_ms}ms")
        if snap["queue_depth"] > slo.max_queue:
            reasons.append(
                f"queue {snap['queue_depth']} > {slo.max_queue}")
        if reject_delta > 0:
            reasons.append(f"{int(reject_delta)} requests unplaceable")
        breach = bool(reasons)
        if breach:
            if self._breach_run == 0:
                self._breach_t0 = now
            self._breach_run += 1
            self._calm_run = 0
        else:
            self._calm_run += 1
            self._breach_run = 0
        action = "hold"
        if breach and self._breach_run >= cfg.breach_ticks \
                and now >= self._cooldown_until:
            action = self._scale_up(snap) or "up_blocked"
        elif not breach and self._calm_run >= cfg.calm_ticks \
                and now >= self._cooldown_until \
                and active > slo.min_replicas:
            action = self._scale_down(snap) or "hold"
        if action in ("up", "down"):
            self._cooldown_until = now + cfg.cooldown_s
            self._breach_run = 0
            self._calm_run = 0
        self._registry.add(f"{self._prefix}.ticks_total", 1)
        self._registry.set(f"{self._prefix}.in_slo", 0 if breach else 1)
        self._registry.set(f"{self._prefix}.active_replicas", active)
        self._registry.set(f"{self._prefix}.breach_run", self._breach_run)
        return {"action": action, "breach": breach, "reasons": reasons,
                "active": active, "p95_ms": snap["p95_ms"],
                "queue_depth": snap["queue_depth"]}

    def _scale_up(self, snap: dict) -> Optional[str]:
        """Unpark the lowest-id parked replica (deterministic order keeps
        the fleet's identity stable across scale cycles)."""
        if snap["active_replicas"] >= self.slo.max_replicas:
            self._registry.add(f"{self._prefix}.up_at_max", 1)
            return None
        parked = snap["parked"]
        if not parked:
            # nothing to unpark: capacity was lost to an exhausted restart
            # budget, not to parking — only ops can fix that
            self._registry.add(f"{self._prefix}.up_blocked", 1)
            return None
        rid = parked[0]
        t0 = self._clock()
        booted = self.router.unpark(rid)
        t1 = self._clock()
        self._registry.observe(f"{self._prefix}.unpark_ms", (t1 - t0) * 1e3)
        if booted:
            self._registry.observe(f"{self._prefix}.breach_to_up_ms",
                                   (t1 - self._breach_t0) * 1e3)
        self._registry.add(f"{self._prefix}.scale_ups", 1)
        _flight.record_event(
            "autoscale_up",
            {"replica": rid, "booted": booted,
             "active": snap["active_replicas"],
             "p95_ms": snap["p95_ms"],
             "queue_depth": snap["queue_depth"]})
        return "up"

    def _scale_down(self, snap: dict) -> Optional[str]:
        """Park the least-loaded active replica (its sequences migrate or
        finish in place; nothing is dropped on a scale-down)."""
        cands = [x for x in snap["replicas"] if x["admissible"]]
        if len(cands) <= self.slo.min_replicas:
            return None
        victim = min(cands,
                     key=lambda x: (x["outstanding"], -x["replica"]))
        t0 = self._clock()
        self.router.park(victim["replica"])
        self._registry.observe(f"{self._prefix}.park_ms",
                               (self._clock() - t0) * 1e3)
        self._registry.add(f"{self._prefix}.scale_downs", 1)
        _flight.record_event(
            "autoscale_down",
            {"replica": victim["replica"],
             "active": snap["active_replicas"]})
        return "down"

    def stats(self) -> dict:
        return self._registry.stats_with_prefix(self._prefix + ".")

    def __repr__(self):
        return (f"Autoscaler({self.slo!r}, "
                f"interval={self.config.interval_s}s)")
