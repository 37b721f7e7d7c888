"""Health-aware replica router: N engine workers (counterpart of
``paddle_tpu/serving/router.py``).

The :class:`Router` runs N in-process
:class:`~paddle_tpu_torch.serving.replica.Replica` workers and keeps
traffic flowing around the sick ones:

* **dispatch**: least outstanding requests among admissible replicas
  (rotating tie-break), retrying on a racing drain; raises
  :class:`NoHealthyReplicas` only when every replica is out;
* **health sweep**: a daemon thread polls each replica's
  :meth:`~paddle_tpu_torch.serving.replica.Replica.healthz`, publishes
  per-replica labelled gauges, drains replicas that turn unhealthy, and
  resurrects DEAD ones through the shared
  :class:`~paddle_tpu_torch.distributed.elastic.RestartBudget`
  (exponential backoff), each from the newest health-stamped checkpoint;
* **graceful drain**: SIGTERM (the chained-handler substrate) or
  :meth:`drain` fans ``begin_drain`` out to every replica and waits for
  every engine worker to stop;
* **zero-loss serving** (``kind="llm"``): a
  :class:`~paddle_tpu_torch.serving.fleet.migrate.FleetMigrator` moves
  running sequences off a parked replica, and with ``recovery`` every
  engine journals its live requests and a killed replica's streams are
  replayed onto survivors.

Devices: the port serves on one card, so every replica runs on the
router's ``device`` (CUDA unless given ``device="cpu"``), as the JAX
package's replicas share one device when it has fewer devices than
replicas (``mesh`` None). ``model_axes`` (model-parallel replicas) is
the second slice of ROADMAP.md queue A10.

**Disaggregated prefill/decode fleet** (``kind="llm"`` with ``roles``):
prefill is a throughput-bound batched matmul, decode a latency-bound
one-token step, and co-located, every long-prompt admission stalls the
other sequences' ticks. With ``roles=("prefill", "decode", ...)`` the
router classifies each request by phase (a prompt of
``prefill_threshold`` tokens or more is prefill-phase) and dispatches it
only to replicas whose role serves that phase ("mixed" serves both).
With ``handoff`` on and ONE host
:class:`~paddle_tpu_torch.serving.llm.PrefixStore` shared by the
replicas (``llm_replica_factory(prefix_store=)``; slot-layout engines),
a prefill-phase request first runs as a one-token warm-up on a
prefill-role replica, whose admission exports the prompt's block-aligned
K/V into the store; the real request then goes decode-phase, and the
decode replica's admission finds the head cached and prefills only the
tail.
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

from ..core import monitor as _mon
from ..core.device import DeviceLike, resolve_device
from ..distributed.elastic import ChainedSignalHandler, RestartBudget
from ..observability import flight as _flight
from .replica import DEAD, DRAINING, HEALTHY, Replica
from .request import (
    PHASE_DECODE, PHASE_PREFILL, REPLICA_ROLES, EngineDraining, ServingError)


class NoHealthyReplicas(ServingError):
    """Every replica is draining, dead, or marked unhealthy — the request
    cannot be placed anywhere."""


class RouterConfig:
    """Tunables for the replica router (see docs/serving.md)."""

    def __init__(self,
                 num_replicas: int = 2,
                 model_axes: Optional[Dict[str, int]] = None,
                 kind: str = "classifier",
                 health_interval: float = 0.2,
                 unhealthy_queue_depth: Optional[int] = None,
                 max_restarts: int = 3,
                 restart_backoff: float = 1.0,
                 restart_backoff_cap: float = 30.0,
                 auto_resurrect: bool = True,
                 checkpoint_root: Optional[str] = None,
                 stat_prefix: str = "serving.router",
                 roles: Optional[Sequence[str]] = None,
                 prefill_threshold: int = 64,
                 handoff: bool = True,
                 handoff_timeout: float = 30.0,
                 recovery: Optional[bool] = None):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        if kind not in ("classifier", "llm"):
            raise ValueError(
                f"kind must be 'classifier' or 'llm', got {kind!r}")
        if roles is not None:
            roles = tuple(str(r) for r in roles)
            if kind != "llm":
                raise ValueError("roles= is only meaningful for kind='llm'")
            if len(roles) != num_replicas:
                raise ValueError(
                    f"roles must name one role per replica: got "
                    f"{len(roles)} roles for {num_replicas} replicas")
            bad = [r for r in roles if r not in REPLICA_ROLES]
            if bad:
                raise ValueError(
                    f"invalid roles {bad}; each must be one of "
                    f"{REPLICA_ROLES}")
            # a fleet that cannot serve one of the phases would reject
            # every request of that phase at dispatch — fail at config time
            for phase in (PHASE_PREFILL, PHASE_DECODE):
                if not any(r in (phase, "mixed") for r in roles):
                    raise ValueError(
                        f"roles {roles} leave no replica serving the "
                        f"{phase} phase (need at least one {phase!r} or "
                        f"'mixed')")
        if prefill_threshold < 1:
            raise ValueError(
                f"prefill_threshold must be >= 1, got {prefill_threshold}")
        self.num_replicas = int(num_replicas)
        self.model_axes = dict(model_axes) if model_axes else None
        self.kind = kind
        self.health_interval = float(health_interval)
        self.unhealthy_queue_depth = unhealthy_queue_depth
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_cap = float(restart_backoff_cap)
        self.auto_resurrect = bool(auto_resurrect)
        self.checkpoint_root = checkpoint_root
        self.stat_prefix = stat_prefix
        self.roles = roles
        self.prefill_threshold = int(prefill_threshold)
        self.handoff = bool(handoff)
        self.handoff_timeout = float(handoff_timeout)
        # zero-loss serving (docs/fault_tolerance.md): arm the sequence
        # journal on every LLM engine boot and replay journaled sequences
        # onto survivors after a kill. Default: on for LLM fleets (the
        # only kind with sequences to lose), off for classifiers.
        self.recovery = (kind == "llm") if recovery is None else \
            bool(recovery)


class Router:
    """Dispatch facade over N health-tracked replicas.

    ``engine_factory(replica) -> engine`` builds each replica's engine
    (see :func:`llm_replica_factory`); it reads ``replica.device``,
    ``replica.registry`` and ``replica.boot_checkpoint``.
    """

    def __init__(self, engine_factory: Callable[[Replica], object],
                 config: Optional[RouterConfig] = None,
                 registry: Optional[_mon.StatRegistry] = None,
                 device: DeviceLike = None,
                 health_source: Optional[Callable[[int], bool]] = None):
        self._config = config or RouterConfig()
        if self._config.model_axes:
            raise NotImplementedError(
                f"model_axes={self._config.model_axes}: model-parallel "
                f"replicas over device meshes are the second slice of "
                f"ROADMAP.md queue A10; "
                f"the port's replicas each run whole on one card")
        self.device = resolve_device(device)
        self._registry = registry or _mon.default_registry()
        self._prefix = self._config.stat_prefix
        self.budget = RestartBudget(self._config.max_restarts,
                                    self._config.restart_backoff,
                                    cap=self._config.restart_backoff_cap)
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._signal_chain: Optional[ChainedSignalHandler] = None
        self._drain_signaled = False   # set (only) from _on_drain_signal
        self._rr = itertools.count()   # rotating tie-break for dispatch
        self._resume_at: Dict[int, float] = {}  # health-thread-only
        self._fanned_out = False                # health-thread-only
        self._degraded_last = 0                 # health-thread-only
        self._parked: set = set()          # autoscaler-parked replica ids
        self._parked_lock = threading.Lock()
        self._trace_recorder = None        # replay.TraceRecorder hook
        # zero-loss serving: LLM fleets get a FleetMigrator (sequence
        # export/import for park + hot-swap) and, when recovery is on, a
        # per-replica kill callback that replays journaled sequences onto
        # survivors. Lazy import: fleet.migrate is control plane and the
        # classifier path must not pay for it.
        self.migrator = None
        recovery_cb = None
        if self._config.kind == "llm":
            from .fleet.migrate import FleetMigrator
            self.migrator = FleetMigrator(self, registry=self._registry)
            if self._config.recovery:
                recovery_cb = self._on_replica_killed
        self.replicas: List[Replica] = []
        for rid in range(self._config.num_replicas):
            src = (None if health_source is None
                   else (lambda r=rid: health_source(r)))
            self.replicas.append(Replica(
                rid, engine_factory, device=self.device,
                checkpoint_root=self._config.checkpoint_root,
                restart_budget=self.budget,
                unhealthy_queue_depth=self._config.unhealthy_queue_depth,
                health_source=src, registry=self._registry,
                recovery_cb=recovery_cb))
        self._health_thread = threading.Thread(
            target=self._health_loop, name="paddle-tpu-router-health",
            daemon=True)
        self._health_thread.start()

    # -- dispatch ------------------------------------------------------------
    @property
    def config(self) -> RouterConfig:
        return self._config

    @property
    def kind(self) -> str:
        return self._config.kind

    @property
    def registry(self) -> _mon.StatRegistry:
        return self._registry

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def _role_of(self, replica_id: int) -> str:
        roles = self._config.roles
        return roles[replica_id] if roles is not None else "mixed"

    def _phase_of(self, args, kwargs) -> Optional[str]:
        """Classify an LLM request by phase: a prompt of
        ``prefill_threshold`` or more tokens is prefill-dominated. Returns
        None (no phase routing) for classifier routers, role-less configs,
        or calls whose prompt cannot be measured."""
        if self._config.kind != "llm" or self._config.roles is None:
            return None
        prompt = args[0] if args else kwargs.get("prompt")
        try:
            n = len(prompt)
        except TypeError:
            return None
        return (PHASE_PREFILL if n >= self._config.prefill_threshold
                else PHASE_DECODE)

    def _pick(self, tried, phase: Optional[str] = None) -> Optional[Replica]:
        cands = [r for r in self.replicas
                 if r.replica_id not in tried and r.admissible
                 and (phase is None
                      or self._role_of(r.replica_id) in (phase, "mixed"))]
        if not cands:
            return None
        low = min(r.outstanding for r in cands)
        mins = [r for r in cands if r.outstanding == low]
        return mins[next(self._rr) % len(mins)]

    def submit(self, *args, **kwargs):
        """Place one request on the least-loaded admissible replica whose
        role serves the request's phase (every replica, for phase-less
        routers). Returns whatever that replica's engine returns (a Future
        for classifier engines, a GenerationRequest for LLM engines).
        Retries on a replica that starts draining between pick and submit;
        raises :class:`NoHealthyReplicas` when no replica can take it.

        Prefill-phase requests go through the KV handoff when it is
        enabled and the fleet shares a prefix store (see the module
        docstring); otherwise they dispatch directly to a
        prefill-serving replica."""
        if self._draining.is_set():
            self._registry.add(f"{self._prefix}.rejected_draining", 1)
            raise EngineDraining("router is draining; submit rejected")
        phase = self._phase_of(args, kwargs)
        if phase == PHASE_PREFILL and self._config.handoff \
                and self._handoff_ready():
            out = self._handoff_submit(args, kwargs)
        else:
            out = self._dispatch(phase, args, kwargs)
        rec = self._trace_recorder
        if rec is not None:
            # record only ACCEPTED requests (rejections raised above) —
            # replay fidelity is about the traffic the fleet admitted
            try:
                rec.on_request(args, kwargs, phase)
            except Exception:
                # a broken recorder must never fail live traffic: count
                # it where /metricsz shows it and keep dispatching
                self._registry.add(
                    f"{self._prefix}.trace_recorder_errors", 1)
        return out

    def set_trace_recorder(self, recorder) -> None:
        """Install a recorder (any object with ``on_request(args, kwargs,
        phase)``, such as
        :class:`~paddle_tpu_torch.serving.fleet.replay.TraceRecorder`)
        observing every accepted request (None removes it). The hook runs
        on the submitter's thread after dispatch."""
        self._trace_recorder = recorder

    def _dispatch(self, phase, args, kwargs):
        tried: set = set()
        relaxed = phase is None
        while True:
            r = self._pick(tried, None if relaxed else phase)
            if r is None:
                if not relaxed:
                    # every phase-matched replica is out — availability
                    # beats placement: serve from any admissible replica
                    relaxed = True
                    self._registry.add(f"{self._prefix}.phase_fallback", 1)
                    continue
                self._registry.add(f"{self._prefix}.rejected_no_replica", 1)
                raise NoHealthyReplicas(
                    f"no admissible replica among {len(self.replicas)} "
                    f"(states: {[x.state for x in self.replicas]})")
            try:
                out = r.submit(*args, **kwargs)
            except EngineDraining:
                # lost the race with a drain — route around it
                tried.add(r.replica_id)
                continue
            self._registry.add(f"{self._prefix}.dispatched", 1)
            if self._config.roles is not None:
                self._registry.add(
                    f"{self._prefix}.dispatched_role_"
                    f"{self._role_of(r.replica_id)}", 1)
                if phase is not None:
                    self._registry.add(
                        f"{self._prefix}.dispatched_phase_{phase}", 1)
            return out

    # -- fleet control plane (autoscaler) ------------------------------------
    def _on_replica_killed(self, replica: Replica) -> None:
        """Replica kill callback (crash recovery): replay the victim's
        journaled sequences onto survivors. Runs on its own daemon
        thread — the callback fires from inside :meth:`Replica.kill`,
        which may hold locks the recovery path (survivor queue puts,
        worker control calls) must not wait behind."""
        t = threading.Thread(
            target=lambda: self.migrator.recover_replica(replica),
            name=f"paddle-tpu-recover-{replica.replica_id}", daemon=True)
        t.start()

    def parked_ids(self) -> List[int]:
        """Replica ids intentionally out of service (autoscale-down)."""
        with self._parked_lock:
            return sorted(self._parked)

    def park(self, replica_id: int) -> bool:
        """Scale-down: take ``replica_id`` out of service and exclude it
        from health-loop resurrection until :meth:`unpark`. False when it
        is already parked. Parking is intentional capacity removal — it
        does not count as degradation and costs no restart budget.

        When the fleet supports live migration, parking does not wait
        for in-flight sequences to finish: admission is paused, every
        running sequence is exported onto the least-loaded siblings
        (paged KV pages travel with it; clients keep streaming), and
        the now-empty replica drains instantly. Sequences that could
        not be moved (report ``remaining`` > 0) finish under the old
        drain-and-wait behavior — migration never drops work."""
        r = self.replicas[replica_id]
        with self._parked_lock:
            if replica_id in self._parked:
                return False
            self._parked.add(replica_id)
        migrated = None
        if self.migrator is not None and \
                getattr(r.engine, "supports_migration", False):
            r.pause()   # stop admission while sequences leave
            migrated = self.migrator.migrate_replica(r, reason="park")
        r.begin_drain()
        self._registry.add(f"{self._prefix}.park_downs", 1)
        _flight.record_event("replica_park", {
            "replica": replica_id,
            "migrated": 0 if migrated is None else migrated["exported"]})
        return True

    def unpark(self, replica_id: int, *, boot_timeout: float = 5.0) -> bool:
        """Scale-up: return a parked replica to service through the
        budgeted boot path — one restart is claimed from the shared
        :class:`RestartBudget`, so a scale-up is a counted resurrection.
        Returns True when the replica booted here; False when it was not
        parked, its park-drain outlasted ``boot_timeout`` (the health loop
        finishes the boot at a later sweep), or the boot failed/budget is
        spent. Parked replicas are idle, so the drain wait normally
        resolves in one worker poll interval; callers run on the
        controller thread, never the dispatch path."""
        r = self.replicas[replica_id]
        with self._parked_lock:
            if replica_id not in self._parked:
                return False
            self._parked.discard(replica_id)
        # a park that migrated paused the replica's admission; the engine
        # booted next must admit (the JAX package's unpark leaves the
        # pause set, so its unparked paged replicas never admit again)
        r.resume()
        self._registry.add(f"{self._prefix}.unpark_ups", 1)
        booted = False
        if r.drain(boot_timeout):   # flips DRAINING -> DEAD; idle => fast
            booted = r.resurrect(consume_budget=True)
            if booted:
                self._registry.add(f"{self._prefix}.resurrections", 1)
        _flight.record_event("replica_unpark",
                             {"replica": replica_id, "booted": booted})
        return booted

    def fleet_snapshot(self) -> dict:
        """The autoscaler's one-call control-plane view: per-replica state
        + load + latency, fleet aggregates, and restart-budget headroom.
        Pure host-side registry/accounting reads — never touches device
        values, so polling it adds zero host syncs to the hot path."""
        parked = set(self.parked_ids())
        reps = []
        for r in self.replicas:
            admissible = r.admissible
            reps.append({
                "replica": r.replica_id,
                "state": r.state,
                "parked": r.replica_id in parked,
                "paused": r.paused,
                "admissible": admissible,
                "outstanding": r.outstanding,
                "queue_depth": r.queue_depth(),
                "p95_ms": self._replica_p95(r),
                "completed": self._replica_completed(r),
                "slots_in_use": self._replica_slots_in_use(r),
            })
        active = [x for x in reps if x["admissible"]]
        stats = self._registry.stats_with_prefix(self._prefix + ".")
        return {
            "replicas": reps,
            "active_replicas": len(active),
            "parked": sorted(parked),
            "queue_depth": sum(x["queue_depth"] for x in reps),
            "outstanding": sum(x["outstanding"] for x in reps),
            # the fleet p95 is the WORST active replica: SLO breaches are
            # per-request, and requests land on one replica
            "p95_ms": max((x["p95_ms"] for x in active), default=0.0),
            # all-time completion count: the autoscaler diffs this per
            # tick so a stale latency reservoir (no traffic since the
            # spike) cannot hold a breach open forever
            "completed": sum(x["completed"] for x in reps),
            "rejected_no_replica": stats.get(
                f"{self._prefix}.rejected_no_replica", 0),
            "degraded": stats.get(f"{self._prefix}.degraded", 0),
            "budget_remaining": self.budget.remaining,
            "draining": self.draining,
        }

    def _replica_p95(self, r: Replica) -> float:
        """p95 request latency of one replica's engine from its histogram
        (0.0 before any traffic)."""
        engine = r.engine
        if engine is None:
            return 0.0
        ep = getattr(engine, "_prefix", None)
        reg = getattr(engine, "registry", None)
        if not ep or reg is None:
            return 0.0
        name = (f"{ep}.request_latency_ms" if self._config.kind == "llm"
                else f"{ep}.latency_ms")
        return reg.quantile(name, 0.95)

    def _replica_completed(self, r: Replica) -> int:
        """All-time completed-request count of one replica's engine (the
        latency histogram's observation count)."""
        engine = r.engine
        if engine is None:
            return 0
        ep = getattr(engine, "_prefix", None)
        reg = getattr(engine, "registry", None)
        if not ep or reg is None:
            return 0
        name = (f"{ep}.request_latency_ms" if self._config.kind == "llm"
                else f"{ep}.latency_ms")
        return int(reg.histogram(name).get("count", 0))

    def _replica_slots_in_use(self, r: Replica) -> int:
        batcher = getattr(r.engine, "_batcher", None)
        active = getattr(batcher, "active", 0)
        return int(active) if isinstance(active, int) else 0

    # -- prefill/decode KV handoff -------------------------------------------
    def _handoff_ready(self) -> bool:
        """The handoff pays off only when a dedicated prefill replica and
        a decode-serving replica share ONE PrefixStore object — otherwise
        the prefilled K/V is invisible to the decode replica and the
        warmup is pure waste."""
        roles = self._config.roles
        if roles is None or PHASE_PREFILL not in roles:
            return False
        stores = {}
        for r in self.replicas:
            store = getattr(r.engine, "prefix_store", None)
            if store is not None:
                stores[r.replica_id] = store
        for rid, store in stores.items():
            if roles[rid] != PHASE_PREFILL:
                continue
            for rid2, store2 in stores.items():
                if rid2 != rid and roles[rid2] in (PHASE_DECODE, "mixed") \
                        and store2 is store:
                    return True
        return False

    def _handoff_submit(self, args, kwargs):
        """KV handoff for a prefill-phase request: run a 1-token warmup
        generation on a prefill-role replica — its admission exports the
        prompt's block-aligned K/V into the SHARED prefix store — then
        dispatch the real request decode-phase, where admission finds the
        prefix cached and prefills only the tail. A failed or timed-out
        warmup degrades gracefully: the decode replica prefills the whole
        prompt itself (slower, never wrong)."""
        prompt = args[0] if args else kwargs.get("prompt")
        pre_kwargs = dict(kwargs)
        pre_kwargs.pop("prompt", None)
        pre_kwargs.update(max_new_tokens=1, stream=False, do_sample=False)
        try:
            pre = self._dispatch(PHASE_PREFILL, (prompt,), pre_kwargs)
            pre.result(timeout=self._config.handoff_timeout)
            self._registry.add(f"{self._prefix}.handoff_prefills", 1)
        except Exception as e:
            self._registry.add(f"{self._prefix}.handoff_failed", 1)
            warnings.warn(
                f"router: prefill handoff failed ({type(e).__name__}: "
                f"{e}); the decode replica will prefill locally")
        return self._dispatch(PHASE_DECODE, args, kwargs)

    # -- health loop ---------------------------------------------------------
    def _health_loop(self):
        try:
            while True:
                if self._draining.is_set():
                    if not self._fanned_out:
                        for r in self.replicas:
                            r.begin_drain()
                        self._fanned_out = True
                    if all(r.poll_drained() for r in self.replicas):
                        break
                else:
                    self._sweep()
                time.sleep(self._config.health_interval)
        finally:
            self._stopped.set()

    def _sweep(self):
        now = time.monotonic()
        parked = set(self.parked_ids())
        for r in self.replicas:
            h = r.healthz()
            rid = r.replica_id
            labels = {"replica": str(rid)}
            self._registry.set_labeled(
                f"{self._prefix}.replica_healthy", labels,
                1 if h["healthy"] else 0)
            self._registry.set_labeled(
                f"{self._prefix}.replica_outstanding", labels,
                h["outstanding"])
            self._registry.set_labeled(
                f"{self._prefix}.replica_queue_depth", labels,
                h["queue_depth"])
            self._registry.set_labeled(
                f"{self._prefix}.replica_restarts", labels, h["restarts"])
            self._registry.set_labeled(
                f"{self._prefix}.replica_parked", labels,
                1 if rid in parked else 0)
            self._registry.set_labeled(
                f"{self._prefix}.replica_p95_ms", labels,
                self._replica_p95(r))
            self._registry.set_labeled(
                f"{self._prefix}.replica_slots_in_use", labels,
                self._replica_slots_in_use(r))
            if self._config.roles is not None:
                # assignment gauge: constant 1 per (replica, role) pair so
                # dashboards can join per-replica series onto roles
                self._registry.set_labeled(
                    f"{self._prefix}.replica_role",
                    {"replica": str(rid), "role": self._role_of(rid)}, 1)
            state = h["state"]
            if state == HEALTHY and not h["healthy"]:
                warnings.warn(
                    f"router: draining replica {rid} "
                    f"(reasons: {h['reasons']})")
                r.begin_drain()
                self._registry.add(
                    f"{self._prefix}.drained_unhealthy", 1)
            elif state == DRAINING:
                r.poll_drained()
            elif state == DEAD and self._config.auto_resurrect:
                if rid in parked:
                    # parked is intentional: no resurrection, and any
                    # pending backoff schedule is void (unpark reboots)
                    self._resume_at.pop(rid, None)
                else:
                    self._maybe_resurrect(r, now)
        # degraded = replicas lost for good (budget exhausted, not parked):
        # the fleet is serving below its declared capacity
        degraded = sum(
            1 for x in self.replicas
            if x.replica_id not in parked
            and self._resume_at.get(x.replica_id) == float("inf"))
        self._registry.set(f"{self._prefix}.degraded", degraded)
        if degraded != self._degraded_last:
            _flight.record_event(
                "router_degraded_change",
                {"degraded": degraded, "was": self._degraded_last,
                 "budget_remaining": self.budget.remaining})
            self._degraded_last = degraded
        self._registry.set(
            f"{self._prefix}.active_replicas",
            sum(1 for x in self.replicas if x.admissible))
        self._registry.set(
            f"{self._prefix}.agg.queue_depth",
            sum(x.queue_depth() for x in self.replicas))

    def _maybe_resurrect(self, r: Replica, now: float):
        """Budgeted, backed-off resurrection (health-thread-only state).
        The budget is claimed HERE — scheduling the pause needs the
        post-consume count — so the replica is told not to claim again."""
        rid = r.replica_id
        due = self._resume_at.get(rid)
        if due is None:
            if self.budget.try_consume():
                self._resume_at[rid] = now + self.budget.pause()
            else:
                warnings.warn(
                    f"router: replica {rid} is DEAD and the restart "
                    f"budget ({self.budget.max_restarts}) is exhausted; "
                    f"it stays down")
                self._resume_at[rid] = float("inf")
            return
        if now < due:
            return
        if r.resurrect(consume_budget=False):
            del self._resume_at[rid]
            self._registry.add(f"{self._prefix}.resurrections", 1)
        else:
            # boot failed — claim another restart for the retry, or park
            if self.budget.try_consume():
                self._resume_at[rid] = now + self.budget.pause()
            else:
                self._resume_at[rid] = float("inf")

    # -- drain / signals -----------------------------------------------------
    def install_drain_signal_handler(self, signals=None):
        """Arm SIGTERM/SIGINT to begin a router-wide drain, chaining — not
        replacing — whatever handler was installed before."""
        if self._signal_chain is not None and self._signal_chain.installed:
            return self._signal_chain
        kwargs = {} if signals is None else {"signals": tuple(signals)}
        self._signal_chain = ChainedSignalHandler(
            self._on_drain_signal, **kwargs)
        self._signal_chain.install()
        return self._signal_chain

    def _on_drain_signal(self, signum, frame):
        """Flag-only (async-signal-safe): the health thread fans the drain
        out to the replicas at its next tick — replica/engine drains take
        queue locks the interrupted thread may hold."""
        self._drain_signaled = True
        self._draining.set()

    def begin_drain(self):
        """Stop admission; the health thread drains every replica."""
        self._draining.set()

    def drain(self, timeout: Optional[float] = None):
        """Graceful router-wide drain: stop admission, drain every
        replica, wait for all engine workers to stop."""
        self.begin_drain()
        self._stopped.wait(timeout)
        if self._signal_chain is not None:
            self._signal_chain.uninstall()

    close = drain

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    # -- observability -------------------------------------------------------
    def healthz(self) -> dict:
        """Aggregate health: ``ok`` (all in-service replicas healthy) /
        ``degraded`` (capacity lost: an unhealthy replica, or one parked
        forever by an exhausted restart budget) / ``unhealthy`` (none
        admissible) / ``draining``. Parked (autoscaled-down) replicas are
        intentional capacity and do not count against the verdict."""
        reps = [r.healthz() for r in self.replicas]
        if self._config.roles is not None:
            for rid, h in enumerate(reps):
                h["role"] = self._role_of(rid)
        parked = set(self.parked_ids())
        for h in reps:
            h["parked"] = h["replica"] in parked
        in_service = [h for h in reps if not h["parked"]]
        stats = self._registry.stats_with_prefix(self._prefix + ".")
        budget_lost = stats.get(f"{self._prefix}.degraded", 0)
        if self._draining.is_set():
            status = "draining"
        elif in_service and all(h["healthy"] for h in in_service) \
                and not budget_lost:
            status = "ok"
        elif any(r.admissible for r in self.replicas):
            status = "degraded"
        else:
            status = "unhealthy"
        return {"status": status, "kind": self.kind, "replicas": reps,
                "parked": sorted(parked),
                "degraded_replicas": budget_lost,
                "budget_remaining": self.budget.remaining}

    def stats(self) -> dict:
        """Router counters + per-replica accounting + the balance factor
        (max dispatched / mean dispatched — 1.0 is a perfectly even
        spread)."""
        per = {str(r.replica_id): r.stats() for r in self.replicas}
        dispatched = [p["dispatched"] for p in per.values()]
        mean = sum(dispatched) / max(1, len(dispatched))
        balance = (max(dispatched) / mean) if mean > 0 else 1.0
        return {
            "stats": self._registry.stats_with_prefix(self._prefix + "."),
            "replicas": per,
            "num_replicas": len(self.replicas),
            "roles": (list(self._config.roles)
                      if self._config.roles is not None else None),
            "draining": self.draining,
            "total_dispatched": sum(dispatched),
            "balance_factor": balance,
        }

    def registries(self) -> List[_mon.StatRegistry]:
        """Every distinct StatRegistry behind this router (identity-
        deduped) — the /metricsz render set."""
        out = [self._registry]
        for r in self.replicas:
            engine = r.engine
            reg = getattr(engine, "registry", None)
            if reg is not None and all(reg is not x for x in out):
                out.append(reg)
        return out

    def __repr__(self):
        return (f"Router(kind={self.kind}, replicas={len(self.replicas)}, "
                f"draining={self.draining})")


# -- engine factories ---------------------------------------------------------

def predictor_replica_factory(model_prefix: str,
                              config=None) -> Callable[[Replica], object]:
    """Factory for classifier replicas over a ``jit.save`` inference
    artifact: loading one is ROADMAP.md queue A11, as for ``Engine`` over
    an artifact path. Serve a callable model through
    :class:`~paddle_tpu_torch.serving.engine.Engine` in a factory of your
    own instead."""
    raise NotImplementedError(
        f"predictor_replica_factory({model_prefix!r}): inference artifacts "
        f"(jit.save, create_predictor) are not ported yet: a later slice "
        f"of the port (ROADMAP.md queue A11)")


def llm_replica_factory(model_factory: Callable[[Replica], object],
                        config=None, *,
                        roles: Optional[Sequence[str]] = None,
                        prefix_store=None,
                        draft_model_factory: Optional[
                            Callable[[Replica], object]] = None
                        ) -> Callable[[Replica], object]:
    """Factory for LLM replicas: ``model_factory(replica)`` builds (or
    restores: ``replica.boot_checkpoint`` names the newest health-stamped
    checkpoint) the GPT model on ``replica.device``; each replica gets an
    :class:`~paddle_tpu_torch.serving.llm.LLMEngine` with a per-replica
    stat prefix (``LLMEngine.stats`` matches prefixes with their trailing
    dot, so two replicas never share counters).

    One model object may serve every replica (``lambda r: model``) for
    dispatch, park, kill and the handoff. A weight roll needs a model per
    replica: the engines' programs read the parameters where they lie,
    so replicas sharing a model share its storage, and a swap on one
    would change the other's weights in the middle of the roll.

    Disaggregation hooks: ``roles`` stamps ``config.role`` per replica
    (pass the same sequence to :class:`RouterConfig`); ``prefix_store`` is
    the ONE host :class:`~paddle_tpu_torch.serving.llm.PrefixStore` every
    replica mounts (slot layout), the prefill->decode KV handoff channel;
    ``draft_model_factory`` builds the speculative draft for ``spec_k >
    0``.
    """
    import copy

    def factory(replica: Replica):
        from .llm import LLMEngine, LLMEngineConfig
        cfg = copy.copy(config) if config is not None else LLMEngineConfig()
        cfg.stat_prefix = f"{cfg.stat_prefix}.replica{replica.replica_id}"
        if roles is not None:
            cfg.role = roles[replica.replica_id]
        model = model_factory(replica)
        draft = (draft_model_factory(replica)
                 if draft_model_factory is not None else None)
        return LLMEngine(model, cfg, registry=replica.registry,
                         draft_model=draft, prefix_store=prefix_store)
    return factory
