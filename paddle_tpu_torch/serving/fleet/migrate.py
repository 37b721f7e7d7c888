"""Zero-loss serving: live sequence migration and in-flight recovery
(counterpart of ``paddle_tpu/serving/fleet/migrate.py``).

A replica leaving the fleet would otherwise either drain (park and
weight swap wait for every running generation) or drop (``kill`` fails
every in-flight request with ``EngineKilled``). A paged sequence's whole
decode state is a block table and refcounted pages, so it can be
exported, shipped and spliced into a sibling replica instead.

* :class:`SequenceManifest`: the versioned host snapshot of one live
  sequence: prompt, generated tokens, sampling, weights version, and the
  K/V page payloads (``GPTPagedDecoder.export_sequence``: NumPy arrays in
  the JAX package's ``[n, L, page, H, D]`` layout, or its int8 ``{"q",
  "s"}`` pair, so either package's engine can splice the other's). The
  resume position is host-derivable (``prompt_len + len(tokens) - 1``),
  so an export costs one device-to-host copy per arena leaf.
* :class:`SequenceJournal`: the crash-recovery half, a bounded ring of
  payload-free records (request, tokens so far, sampling), noted by the
  engine worker each tick by reference and copied on the journal's own
  thread, so journaling adds no host sync to a tick. A record may lag
  the stream by a few tokens; the replay re-generates the gap and the
  request's dedup guard verifies each re-generated token.
* :class:`FleetMigrator`: the router's orchestrator. A planned migration
  (``Router.park``, ``WeightSwapper.roll``) exports every running
  sequence between ticks and imports it into the least-loaded sibling on
  the same weights version, rebinding the SAME ``GenerationRequest``, so
  the client's token iterator never notices. A stream never moves to
  other weights (the JAX package's last-resort replay across versions
  can mix them): what no same-version sibling takes goes back to its
  donor, and a killed replica's streams replay only on survivors of
  their version, else fail retryably. Crash recovery replays
  journaled sequences onto survivors by re-prefilling ``prompt +
  journaled tokens``; the dedup guard raises
  :class:`~paddle_tpu_torch.serving.request.TokenStreamDivergence` rather
  than emit a duplicate or a gap.

Fault sites (``PADDLE_TPU_FAULT_SPEC``): ``seq_export`` (donor side,
``fail``/``slow_io``), ``seq_import`` (target side, ``fail`` forces the
next target or the replay), ``journal_write`` (the flush thread,
``drop`` keeps records stale, ``fail``/``disk_full`` count write errors).

Export and import run on each engine's worker between ticks
(``LLMEngine._run_on_worker``), never under a replaying program. Every
fallback ends in a retryable failure, never a silent loss.
"""
from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ...core import monitor as _mon
from ...observability import flight as _flight
from ...utils.resilience import fault_injector
from ..request import EngineKilled

#: bump when the manifest layout changes; import refuses newer versions
#: (a rolling fleet can hold two builds briefly — never guess at fields)
MANIFEST_VERSION = 1


def prompt_fingerprint(prompt) -> str:
    """Stable payload-free identity of a prompt (journal records and
    manifests carry this instead of trusting object identity)."""
    arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
    return hashlib.sha1(arr.tobytes()).hexdigest()


class SequenceManifest:
    """One live sequence, snapshotted for shipping.

    ``k_pages``/``v_pages`` are the stacked host page payloads from
    ``PagedKVCache.read_pages`` (index ``i`` backs logical page ``i``),
    or ``None`` for a *cold* manifest — a request that was still queued
    on the donor and just needs re-queueing, no state to splice.
    ``n_cached_tokens`` is the resume position: the number of logical
    rows the payload backs (``prompt_len + len(tokens) - 1`` — the last
    emitted token is by design not yet in the cache; the importing
    engine's next tick writes it).
    """

    __slots__ = ("version", "req", "prompt", "tokens", "sampling",
                 "weights_version", "n_cached_tokens", "page_size",
                 "sig", "k_pages", "v_pages", "source", "prompt_hash")

    def __init__(self, req, prompt, tokens, sampling, weights_version,
                 n_cached_tokens, page_size, sig, k_pages=None,
                 v_pages=None, source=None):
        self.version = MANIFEST_VERSION
        self.req = req
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.tokens = list(tokens)
        self.sampling = sampling
        self.weights_version = None if weights_version is None \
            else int(weights_version)
        self.n_cached_tokens = int(n_cached_tokens)
        self.page_size = int(page_size)
        self.sig = sig
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.source = source
        self.prompt_hash = prompt_fingerprint(self.prompt)

    @classmethod
    def for_queued(cls, req, source=None) -> "SequenceManifest":
        """Manifest for a request still queued on the donor: no device
        state, no emitted tokens — a plain re-queue moves it."""
        return cls(req, req.prompt, req.tokens, req.sampling,
                   weights_version=req.weights_version,
                   n_cached_tokens=0, page_size=0, sig=None,
                   source=source)

    @property
    def cold(self) -> bool:
        """True when there is no device state to splice (the request
        never reached a slot on the donor — just re-queue it)."""
        return self.k_pages is None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    def __repr__(self):
        return (f"SequenceManifest(v{self.version}, "
                f"req={getattr(self.req, 'req_id', None)}, "
                f"prompt={self.prompt_len}, tokens={len(self.tokens)}, "
                f"cached={self.n_cached_tokens}, "
                f"{'cold' if self.cold else 'warm'})")


class JournalRecord:
    """One journaled sequence: payload-free, a few hundred bytes."""

    __slots__ = ("req", "req_id", "prompt_hash", "tokens", "sampling",
                 "weights_version", "t_flushed")

    def __init__(self, req, tokens, t_flushed):
        self.req = req
        self.req_id = req.req_id
        self.prompt_hash = prompt_fingerprint(req.prompt)
        self.tokens = list(tokens)
        self.sampling = req.sampling
        self.weights_version = req.weights_version
        self.t_flushed = t_flushed


class SequenceJournal:
    """Bounded ring of per-tick sequence records, flushed off-thread.

    The engine worker calls :meth:`note` once per tick with the live
    request set — an O(1) reference enqueue, no copying, no host sync
    (the async-dispatch discipline: the tick never pays for
    durability). A daemon flush thread snapshots each request's
    ``tokens`` list into the ring. Because the flush lags the tick, a
    record may be a few tokens STALE at crash time; recovery replays
    the gap deterministically and the dedup guard verifies it — lag is
    a latency cost, never a correctness cost.
    """

    def __init__(self, capacity: int = 1024,
                 registry: Optional[_mon.StatRegistry] = None,
                 stat_prefix: str = "serving.llm.journal",
                 flush_interval: float = 0.01, clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"journal capacity must be >= 1: {capacity}")
        self.capacity = int(capacity)
        self._registry = registry if registry is not None \
            else _mon.default_registry()
        self._prefix = stat_prefix
        self._clock = clock
        self._lock = threading.Lock()
        # newest note wins; older pending snapshots are superseded, so a
        # slow flusher drops intermediate states, never the newest
        self._pending = collections.deque(maxlen=8)
        self._records: "collections.OrderedDict[int, JournalRecord]" = \
            collections.OrderedDict()
        self.write_errors = 0
        self.flushes = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._flush_interval = float(flush_interval)
        self._thread = threading.Thread(
            target=self._flush_loop, name="paddle-tpu-torch-seq-journal",
            daemon=True)
        self._thread.start()

    # -- hot path (engine worker) --------------------------------------------
    def note(self, reqs):
        """Record the live request set as of this tick. O(1): stores
        references only; the flush thread does the copying."""
        self._pending.append(tuple(reqs))
        self._wake.set()

    # -- flush thread ---------------------------------------------------------
    def _flush_loop(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=self._flush_interval)
            self._wake.clear()
            self.flush_pending()

    def flush_pending(self):
        """Drain queued notes into the ring (flush-thread body; also
        callable directly in tests for deterministic journals)."""
        batch = None
        while self._pending:
            try:
                batch = self._pending.popleft()
            except IndexError:      # racing producer on an empty deque
                break
        if batch is None:
            return
        action = fault_injector().fire("journal_write")
        if action == "drop":
            # simulated lost write: the ring keeps its STALE records —
            # exactly the state a real crash leaves behind
            return
        if action == "slow_io":
            time.sleep(float(os.environ.get(
                "PADDLE_TPU_FAULT_SLOW_IO_S", "1.0")))
        if action in ("fail", "disk_full"):
            self.write_errors += 1
            self._registry.add(f"{self._prefix}.write_errors", 1)
            return
        now = self._clock()
        with self._lock:
            for req in batch:
                if req.finish_reason is not None:
                    self._records.pop(req.req_id, None)
                    continue
                # list() snapshots under the GIL; _emit only appends, so
                # the copy is always a consistent prefix of the stream
                rec = JournalRecord(req, list(req.tokens), now)
                self._records[rec.req_id] = rec
                self._records.move_to_end(rec.req_id)
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
            self.flushes += 1
            n = len(self._records)
        self._registry.set(f"{self._prefix}.entries", n)

    # -- recovery read side ----------------------------------------------------
    def snapshot(self) -> List[JournalRecord]:
        """The current ring, newest-note order — deliberately WITHOUT a
        synchronous flush: recovery sees exactly what a real crash
        would have persisted."""
        with self._lock:
            return [rec for rec in self._records.values()
                    if rec.req.finish_reason is None]

    def lookup(self, req_id: int) -> Optional[JournalRecord]:
        with self._lock:
            return self._records.get(req_id)

    def forget(self, req_id: int):
        with self._lock:
            self._records.pop(req_id, None)

    def __len__(self):
        with self._lock:
            return len(self._records)

    def close(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)


class FleetMigrator:
    """Router-side migration + recovery orchestrator.

    Stateless between calls: every decision reads the router's live
    snapshot. All counters land under ``fleet.migrate.*`` on the
    router registry (and therefore ``/metricsz``).
    """

    def __init__(self, router,
                 registry: Optional[_mon.StatRegistry] = None,
                 stat_prefix: str = "fleet.migrate",
                 export_timeout: float = 30.0,
                 import_timeout: float = 30.0, clock=time.monotonic):
        self.router = router
        self._registry = registry if registry is not None \
            else router.registry
        self._prefix = stat_prefix
        self._export_timeout = float(export_timeout)
        self._import_timeout = float(import_timeout)
        self._clock = clock

    def _add(self, name, v=1):
        self._registry.add(f"{self._prefix}.{name}", v)

    # -- target selection ------------------------------------------------------
    def _targets(self, exclude_id: int) -> List:
        """Admissible siblings able to receive sequences, least-loaded
        first. (Version preference is applied by the caller: splicing
        KV computed under other weights would silently mix models — the
        hot-swap tests pin 'old OR new, never mixed'.)"""
        out = [r for r in self.router.replicas
               if r.replica_id != exclude_id and r.engine is not None
               and r.admissible]
        out.sort(key=lambda r: (r.outstanding, r.replica_id))
        return out

    # -- planned migration -----------------------------------------------------
    def migrate_replica(self, replica, *, reason: str = "migrate") -> Dict:
        """Move every running sequence off ``replica`` onto siblings.

        The donor must already have admission paused (park and swap
        both do). Returns a report; ``remaining`` > 0 means some
        sequences could not be moved (the caller falls back to the old
        drain-and-wait behavior for those — never a drop)."""
        report = {"reason": reason, "exported": 0, "imported": 0,
                  "replayed": 0, "requeued": 0, "kept": 0, "failed": 0,
                  "remaining": 0, "error": None}
        engine = replica.engine
        if engine is None or not getattr(engine, "supports_migration",
                                         False):
            report["error"] = "unsupported"
            return report
        t0 = self._clock()
        try:
            manifests = engine.export_sequences(
                timeout=self._export_timeout)
        except Exception as e:  # noqa: BLE001 -- any export failure must fall back to drain, not crash the control plane
            report["error"] = f"export: {e!r}"
            self._add("export_failures")
            return report
        report["exported"] = len(manifests)
        self._add("sequences_exported", len(manifests))
        for man in manifests:
            man.source = replica.replica_id
            outcome = self._place(man, exclude_id=replica.replica_id)
            report[outcome] += 1
        report["remaining"] = int(getattr(engine._batcher, "active", 0))
        self._registry.observe(f"{self._prefix}.latency_ms",
                               (self._clock() - t0) * 1000.0)
        _flight.record_event("sequence_migrate", {
            "replica": replica.replica_id, "reason": reason,
            **{k: report[k] for k in
               ("exported", "imported", "replayed", "requeued",
                "failed")}})
        return report

    def _same_version(self, targets, version) -> List:
        """The targets serving weights ``version`` (every target when the
        request was never admitted)."""
        if version is None:
            return list(targets)
        return [t for t in targets
                if getattr(t.engine, "weights_version", None) == version]

    def _place(self, man: SequenceManifest, *, exclude_id: int) -> str:
        """One manifest onto the fleet. Returns the outcome counter
        name: imported | replayed | requeued | kept | failed.

        A stream stays on its weights generation: the JAX package falls
        back to a replay on a sibling of another version, but a replay
        re-prefills the transcript the client already has, so with
        nothing left to verify the dedup guard passes and the stream
        goes on under the other weights, a mix (ROADMAP.md C13). Here a
        sequence no same-version sibling takes goes back to its donor
        (``kept``), which finishes it on its own weights under the
        swap's quiesce or the park's drain."""
        targets = self._targets(exclude_id)
        same = self._same_version(targets, man.weights_version)
        if man.cold:
            # no device state: a plain re-queue; a request with streamed
            # tokens (mid-replay, shipped payload-free) only where its
            # weights serve
            pool = same if man.req.tokens else targets
            for target in pool:
                if self._try(lambda t=target: t.engine.resubmit(man.req)):
                    self._add("sequences_requeued")
                    return "requeued"
            return self._keep(man, exclude_id, "no sibling could re-queue")
        for target in same:
            if self._try(lambda t=target: t.engine.import_sequence(
                    man, timeout=self._import_timeout)):
                self._add("sequences_imported")
                return "imported"
            self._add("import_failures")
        # page splice impossible (pool pressure, injected faults): replay
        # through a prefill instead, slower, token-exact for greedy
        # streams up to near ties
        for target in same:
            if self._try(lambda t=target: t.engine.resubmit_for_recovery(
                    man.req, man.tokens)):
                self._add("sequences_replayed")
                return "replayed"
        return self._keep(man, exclude_id,
                          "no sibling on its weights could adopt or replay")

    def _keep(self, man: SequenceManifest, donor_id: int, why: str) -> str:
        """Put a sequence no sibling could take back into its donor (its
        admission paused, its worker still serving), else fail it
        retryably."""
        engine = self.router.replicas[donor_id].engine
        if engine is not None:
            put = ((lambda: engine.resubmit(man.req)) if man.cold else
                   (lambda: engine.import_sequence(
                       man, timeout=self._import_timeout)))
            if self._try(put):
                self._add("sequences_kept")
                return "kept"
        return self._fail(man.req, why)

    @staticmethod
    def _try(fn) -> bool:
        try:
            return bool(fn())
        except Exception:  # noqa: BLE001 -- a sick target must not sink the whole migration; the next target gets its chance
            return False

    def _fail(self, req, why: str) -> str:
        self._add("sequences_failed")
        # retryable by contract: the client resubmits from scratch, so
        # even the worst-case fallback is a retry, never a loss
        req.fail(EngineKilled(
            f"sequence migration failed for request "
            f"{getattr(req, 'req_id', '?')}: {why}; retry"))
        return "failed"

    # -- crash recovery --------------------------------------------------------
    def recover_replica(self, replica, *, wait_timeout: float = 30.0,
                        reason: str = "engine killed") -> Dict:
        """Replay a killed replica's journaled sequences onto survivors.

        Called after ``Replica.kill`` (or the health sweep declaring an
        engine dead). Waits for the donor worker to stop — its last act
        is evacuating in-flight requests WITHOUT failing them — then,
        for each evacuated request, re-prefills ``prompt +
        journaled_tokens`` on a survivor. The journal may lag the
        stream; the re-generated gap is verified token-by-token by the
        request's dedup guard before anything reaches the client."""
        report = {"reason": reason, "evacuated": 0, "replayed": 0,
                  "failed": 0}
        engine = replica.engine
        if engine is None:
            return report
        stopped = getattr(engine, "_stopped", None)
        if stopped is not None and not stopped.wait(wait_timeout):
            # the worker never exited: evacuation cannot be trusted —
            # leave the requests to the engine's own abort path
            report["failed"] = -1
            return report
        victims = engine.take_evacuated() \
            if hasattr(engine, "take_evacuated") else []
        journal = getattr(engine, "journal", None)
        report["evacuated"] = len(victims)
        for req in victims:
            if req.finish_reason is not None or req.future.done():
                continue
            rec = journal.lookup(req.req_id) if journal is not None \
                else None
            resume = list(rec.tokens) if rec is not None else []
            placed = False
            # only onto its own weights: a replay on other weights would
            # mix them into the stream (C13); no such survivor, a retry
            for target in self._same_version(
                    self._targets(replica.replica_id), req.weights_version):
                if self._try(lambda: target.engine.resubmit_for_recovery(
                        req, resume)):
                    placed = True
                    break
            if placed:
                report["replayed"] += 1
                self._add("sequences_recovered")
            else:
                report["failed"] += 1
                self._fail(req, "no survivor could replay")
        if journal is not None:
            journal.close()     # read: the dead engine's flusher can stop
        _flight.record_event("sequence_recover", {
            "replica": replica.replica_id, **{
                k: report[k] for k in ("evacuated", "replayed",
                                       "failed")}})
        return report

    def stats(self) -> Dict:
        return self._registry.stats_with_prefix(self._prefix + ".")
