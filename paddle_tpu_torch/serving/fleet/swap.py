"""Live weight hot-swap: roll a committed checkpoint across the fleet
(counterpart of ``paddle_tpu/serving/fleet/swap.py``).

One replica at a time: pause (the router stops dispatching, the engine
keeps its in-flight work), migrate out (running sequences move, paged KV
pages and all, onto siblings still on the prior weights, so the quiesce
is instant; a fleet without live migration drains the old way), quiesce
(every slot retires behind the paused admission), swap
(``set_state_dict`` in place and the parameters read again: the captured
decode and prefill programs read the weights where they lie, so a roll
captures nothing and the executable cache's misses stay put), probe (a
short greedy generation straight into the engine, version-checked),
readmit. A failed probe rolls the replica back to the weights it served
before the swap (host copies taken just before the roll touches the
model) and aborts the rest of the roll.

Eligibility is checked before any replica is paused:
:func:`~paddle_tpu_torch.incubate.checkpoint.sharded.swap_eligible`
wants a committed checkpoint directory, a healthy stamp and a clean
checksum sweep. The checkpoint is loaded once onto the host, and each
replica copies it into its own model. The check's and the load's wall
ms are observed as ``fleet.swap.eligible_ms`` and ``fleet.swap.load_ms``.

Every replica needs a model object of its own: two engines over one
model read the same parameter storage, so a swap on one would change the
other's weights in the middle of the roll (``llm_replica_factory``).

Chaos hook: the ``weight_swap`` fault site fires once per replica swap
(``fail``/``disk_full`` force the rollback, ``slow_io`` stretches the
swap window).
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

from ...core import monitor as _mon
from ...observability import flight as _flight
from ...observability import tracer as _otrace
from ...utils.resilience import fault_injector


class SwapError(RuntimeError):
    """A weight roll was refused (ineligible checkpoint) or a replica
    swap failed its probe (the replica was rolled back)."""


class WeightSwapper:
    """Roll health-stamped checkpoints across a ``kind="llm"`` Router."""

    def __init__(self, router, registry: Optional[_mon.StatRegistry] = None,
                 *, probe_prompt=None, probe_new_tokens: int = 2,
                 probe_timeout: float = 30.0, quiesce_timeout: float = 30.0,
                 stat_prefix: str = "fleet.swap", clock=time.monotonic):
        if router.kind != "llm":
            raise ValueError(
                "WeightSwapper drives LLMEngine replicas; classifier "
                "routers reload via predictor artifacts, not live swaps")
        self.router = router
        self._registry = registry if registry is not None else router.registry
        self._prefix = stat_prefix
        self._probe_prompt = (list(probe_prompt)
                              if probe_prompt is not None else [1, 2, 3])
        self._probe_new_tokens = int(probe_new_tokens)
        self._probe_timeout = float(probe_timeout)
        self._quiesce_timeout = float(quiesce_timeout)
        self._clock = clock

    # -- public API ----------------------------------------------------------
    def roll(self, checkpoint_path: str, *, verify: bool = True) -> dict:
        """Swap ``checkpoint_path`` onto every serving replica, one at a
        time. Returns the roll report; raises :class:`SwapError` without
        touching any replica when the checkpoint is not swap-eligible.

        A replica whose post-swap probe fails is rolled back to its prior
        weights and the roll is aborted (replicas already swapped stay on
        the new weights — re-issue the roll after fixing the checkpoint to
        converge, or roll the prior checkpoint to walk them back)."""
        from ...incubate.checkpoint.sharded import load_sharded, swap_eligible
        t0 = time.perf_counter()
        ok, reason = swap_eligible(checkpoint_path, verify=verify)
        self._registry.observe(f"{self._prefix}.eligible_ms",
                               (time.perf_counter() - t0) * 1e3)
        if not ok:
            self._registry.add(f"{self._prefix}.refused", 1)
            raise SwapError(f"refusing weight roll: {reason}")
        # onto the host once (just verified); each replica copies it in
        t0 = time.perf_counter()
        state = load_sharded(checkpoint_path, return_tensor=False,
                             verify=False, device="cpu")
        self._registry.observe(f"{self._prefix}.load_ms",
                               (time.perf_counter() - t0) * 1e3)
        weights = state["model"] if "model" in state else state
        self._registry.add(f"{self._prefix}.rolls", 1)
        report = {"checkpoint": checkpoint_path, "swapped": [],
                  "skipped": [], "rolled_back": None, "failed": None,
                  "downtime_ms": {}, "versions": {}, "aborted": False}
        _flight.record_event("weight_roll_begin",
                             {"checkpoint": checkpoint_path})
        for replica in self.router.replicas:
            rid = replica.replica_id
            if rid in set(self.router.parked_ids()) \
                    or replica.state != "HEALTHY":
                report["skipped"].append(rid)
                continue
            ok = self._swap_one(replica, weights, report)
            if not ok:
                report["aborted"] = True
                break
        _flight.record_event(
            "weight_roll_end",
            {"checkpoint": checkpoint_path,
             "swapped": report["swapped"],
             "rolled_back": report["rolled_back"],
             "aborted": report["aborted"]})
        return report

    # -- per-replica sequence ------------------------------------------------
    def _swap_one(self, replica, weights: Dict, report: dict) -> bool:
        rid = replica.replica_id
        engine = replica.engine
        with _otrace.span("fleet/weight_swap", {"replica": rid}):
            # rollback source: the weights this replica serves RIGHT NOW,
            # as host copies (state_dict() returns live tensor refs that
            # set_state_dict would overwrite in place)
            prior = {k: v.detach().to("cpu", copy=True)
                     for k, v in engine.decoder.model.state_dict().items()}
            t0 = self._clock()
            replica.pause()
            engine.pause_admission()
            try:
                action = fault_injector().fire("weight_swap")
                if action == "slow_io":
                    time.sleep(float(os.environ.get(
                        "PADDLE_TPU_FAULT_SLOW_IO_S", "0.2")))
                # zero-loss roll: instead of waiting for the quiesce to
                # drain every in-flight sequence through this (possibly
                # slow_io-widened) window, move them — KV pages and all —
                # onto siblings still serving the prior weights. The
                # swap's internal quiesce then completes instantly. Any
                # sequence migration could not move (no migrator, engine
                # without paged KV, no admissible sibling) simply rides
                # out the quiesce as before — a latency cost, never a
                # drop.
                migrator = getattr(self.router, "migrator", None)
                if migrator is not None and \
                        getattr(engine, "supports_migration", False):
                    mig = migrator.migrate_replica(replica, reason="swap")
                    report.setdefault("migrated", {})[rid] = (
                        mig["imported"] + mig["replayed"] + mig["requeued"])
                version = engine.swap_weights(
                    weights, timeout=self._quiesce_timeout)
                if action in ("fail", "disk_full"):
                    raise SwapError(
                        f"fault injection: weight swap on replica {rid} "
                        f"hit {action}")
                engine.resume_admission()
                if not self._probe(engine, version):
                    raise SwapError(
                        f"replica {rid} failed its post-swap probe")
            except Exception as e:
                self._rollback(replica, engine, prior, e, report)
                return False
            replica.resume()
            downtime = (self._clock() - t0) * 1000.0
            report["swapped"].append(rid)
            report["versions"][rid] = version
            report["downtime_ms"][rid] = downtime
            self._registry.add(f"{self._prefix}.replicas_swapped", 1)
            self._registry.observe(f"{self._prefix}.downtime_ms", downtime)
            _flight.record_event(
                "weight_swap_ok",
                {"replica": rid, "version": version,
                 "downtime_ms": downtime})
            return True

    def _probe(self, engine, expect_version: int) -> bool:
        """Health-check the swapped engine with a short greedy generation
        submitted DIRECTLY to the engine (the replica is paused, so no
        router traffic mixes into the probe window). The result must
        carry the expected weights version — the bitwise old-or-new
        guarantee made observable."""
        try:
            req = engine.submit(self._probe_prompt,
                                max_new_tokens=self._probe_new_tokens)
            res = req.result(timeout=self._probe_timeout)
        except Exception:
            return False
        return (res.get("weights_version") == expect_version
                and len(res.get("tokens", ())) >= 1)

    def _rollback(self, replica, engine, prior: Dict, cause: BaseException,
                  report: dict):
        """Swap the prior weights back and re-probe; a replica that fails
        even the rollback probe is marked unhealthy so the health sweep
        drains it and resurrects from the newest health-stamped
        checkpoint."""
        rid = replica.replica_id
        self._registry.add(f"{self._prefix}.rollbacks", 1)
        _flight.record_event(
            "weight_swap_rollback",
            {"replica": rid, "cause": f"{type(cause).__name__}: {cause}"})
        try:
            engine.pause_admission()
            version = engine.swap_weights(
                prior, timeout=self._quiesce_timeout)
            engine.resume_admission()
            ok = self._probe(engine, version)
        except Exception:
            ok = False
        if ok:
            replica.resume()
            report["rolled_back"] = rid
        else:
            # can't even serve the old weights: hand the replica to the
            # health sweep (drain -> DEAD -> budgeted resurrection from
            # the newest health-stamped checkpoint)
            self._registry.add(f"{self._prefix}.failed", 1)
            replica.mark_unhealthy("weight-swap rollback probe failed")
            replica.resume()
            report["failed"] = rid

    def stats(self) -> dict:
        return self._registry.stats_with_prefix(self._prefix + ".")
