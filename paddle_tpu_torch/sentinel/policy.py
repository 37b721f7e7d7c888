"""Anomaly policy engine: the configurable escalation ladder
(counterpart of ``paddle_tpu/sentinel/policy.py``).

One anomaly is usually a poisoned batch; five in a row is a diverged run.
The ladder maps *consecutive* anomaly counts to increasingly drastic
responses::

    skip_step → quarantine_batch → rollback → halt

- ``skip_step``        refuse the update (the parameters, the moments,
  the step count and the lr/step scalars stay as they were)
- ``quarantine_batch`` also dump the offending inputs for offline repro
- ``rollback``         restore the newest healthy snapshot
  (:class:`~paddle_tpu_torch.sentinel.rollback.CheckpointRollback`),
  optionally rescaling the LR
- ``halt``             dump the flight recorder when it is armed and exit
  with :data:`~paddle_tpu_torch.distributed.elastic.DIVERGENCE_EXIT_CODE`,
  which an elastic supervisor does not restart

A healthy step resets the consecutive count; every rung also skips the
poisoned update.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import warnings
from typing import List, Optional, Tuple

from ..core import monitor as _monitor
from ..distributed.elastic import DIVERGENCE_EXIT_CODE
from ..utils.resilience import fault_injector
from .detector import LossSpikeDetector
from .guard import StepGuard, poison_grads, poison_loss
from .quarantine import quarantine_batch

#: every action a ladder may contain, mildest first
ACTIONS = ("skip_step", "quarantine_batch", "rollback", "halt")

DEFAULT_LADDER = ("skip_step", "quarantine_batch", "rollback", "halt")


@dataclasses.dataclass
class SentinelConfig:
    """Knobs for :class:`Sentinel` (all host-side; nothing here recompiles
    the step)."""

    check_every: int = 1          # probe every Nth optimizer step
    ladder: Tuple[str, ...] = DEFAULT_LADDER
    tolerance: int = 1            # consecutive anomalies per rung
    z_threshold: float = 6.0      # loss-spike z-score trip point
    ewma_alpha: float = 0.05
    warmup_steps: int = 20        # detector learns before it may trip
    quarantine_dir: Optional[str] = None
    quarantine_max: int = 8
    lr_rescale: float = 1.0       # LR multiplier applied on rollback
    halt_exit_code: int = DIVERGENCE_EXIT_CODE

    def __post_init__(self):
        unknown = [a for a in self.ladder if a not in ACTIONS]
        if unknown:
            raise ValueError(
                f"unknown sentinel action(s) {unknown}; valid: {ACTIONS}")
        if not self.ladder:
            raise ValueError("ladder must have at least one action")
        if int(self.check_every) < 1:
            raise ValueError(f"check_every must be >= 1, got "
                             f"{self.check_every}")
        if int(self.tolerance) < 1:
            raise ValueError(f"tolerance must be >= 1, got {self.tolerance}")


@dataclasses.dataclass
class AnomalyReport:
    """What the sentinel saw and did for one guarded step."""

    step: int
    anomalous: bool
    reasons: List[str] = dataclasses.field(default_factory=list)
    action: Optional[str] = None
    loss: Optional[float] = None
    z: Optional[float] = None
    rolled_back_to: Optional[int] = None


class PolicyEngine:
    """Maps consecutive-anomaly counts onto the ladder."""

    def __init__(self, ladder: Tuple[str, ...] = DEFAULT_LADDER,
                 tolerance: int = 1):
        self.ladder = tuple(ladder)
        self.tolerance = max(1, int(tolerance))

    def decide(self, consecutive: int) -> str:
        rung = min((max(1, consecutive) - 1) // self.tolerance,
                   len(self.ladder) - 1)
        return self.ladder[rung]


class Sentinel:
    """Numerical-anomaly sentinel for the optimizer step.

    ::

        sentinel = Sentinel(SentinelConfig(ladder=("skip_step", "halt")),
                            optimizer=opt, rollback=rb)
        for x, y in loader:
            loss = loss_fn(net(x), y)
            loss.backward()
            sentinel.observe(loss=loss, batch=([x], [y]))  # optional ctx
            opt.step()      # guarded: NaN grads can never reach params
            opt.clear_grad()

    ``attach`` hooks :meth:`approve_step` into ``Optimizer.step`` so
    existing training loops are guarded without restructuring; a healthy
    guarded step costs one probe replay plus one 8-byte fetch
    (``sentinel.host_syncs``), and ``check_every=N`` amortizes that to
    every Nth step. The FaultInjector sites ``grads`` / ``loss`` with the
    ``nan`` action poison the corresponding values right before the probe,
    making every rung deterministically testable
    (``PADDLE_TPU_FAULT_SPEC="grads:5:nan"``).
    """

    def __init__(self, config: Optional[SentinelConfig] = None,
                 optimizer=None, rollback=None):
        self.config = config or SentinelConfig()
        self.guard = StepGuard(self.config.check_every)
        self.detector = LossSpikeDetector(
            alpha=self.config.ewma_alpha,
            z_threshold=self.config.z_threshold,
            warmup_steps=self.config.warmup_steps)
        self.policy = PolicyEngine(self.config.ladder, self.config.tolerance)
        self.rollback = rollback
        self.last_report: Optional[AnomalyReport] = None
        self._step = 0
        self._consecutive = 0
        self.anomalies = 0  # lifetime total, all paths
        self._ctx_loss = None
        self._ctx_batch = None
        self._optimizer = None
        self._warned_no_rollback = False
        #: optional zero-arg callable returning the current ``(xs, ys)``
        #: batch for quarantine dumps when no batch was ``observe``d —
        #: AnomalyGuardCallback points this at ``Model._last_batch``
        self.batch_getter = None
        if optimizer is not None:
            self.attach(optimizer)

    # -- wiring --------------------------------------------------------------
    def attach(self, optimizer) -> "Sentinel":
        """Guard ``optimizer.step()`` (the hook lives in Optimizer.step)."""
        optimizer._sentinel = self
        self._optimizer = optimizer
        return self

    def detach(self, optimizer=None):
        opt = optimizer or self._optimizer
        if opt is not None and getattr(opt, "_sentinel", None) is self:
            opt._sentinel = None
        if opt is self._optimizer:
            self._optimizer = None

    def observe(self, loss=None, batch=None):
        """Give the next guarded step its context: the loss the trainer
        already holds (device scalar or the float it fetched for logging)
        and optionally the raw batch for quarantine dumps."""
        self._ctx_loss = loss
        self._ctx_batch = batch

    # -- the guard hook ------------------------------------------------------
    def approve_step(self, optimizer) -> bool:
        """Called by ``Optimizer.step``; True means apply the update."""
        step = self._step
        self._step += 1
        loss, batch = self._ctx_loss, self._ctx_batch
        self._ctx_loss = self._ctx_batch = None
        if batch is None and self.batch_getter is not None:
            batch = self.batch_getter()

        fi = fault_injector()
        if fi.armed("grads") and fi.fire("grads") == "nan":
            poison_grads(optimizer)
        if fi.armed("loss") and fi.fire("loss") == "nan":
            loss = poison_loss(loss)

        if not self.guard.should_check(step):
            return True  # amortized-out step: zero probe cost

        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        loss_raw = getattr(loss, "_data", loss)  # Tensor -> torch tensor
        if not grads and loss_raw is None:
            return True  # nothing to probe

        finite, loss_val = self.guard.probe(
            grads, loss_raw, device=getattr(optimizer, "_device", None))
        reasons: List[str] = []
        z = None
        if not finite:
            reasons.append("non_finite")
            _monitor.stat_add("sentinel.nan_steps", 1)
        elif loss_val is not None:
            z, spike = self.detector.update(loss_val)
            _monitor.stat_observe("sentinel.loss_z", z)
            if spike:
                reasons.append(f"loss_spike(z={z:.2f})")
                _monitor.stat_add("sentinel.spike_steps", 1)

        if not reasons:
            self._consecutive = 0
            self.last_report = AnomalyReport(step, False, loss=loss_val, z=z)
            return True

        self._consecutive += 1
        self.anomalies += 1
        action = self.policy.decide(self._consecutive)
        report = AnomalyReport(step, True, reasons=reasons, action=action,
                               loss=loss_val, z=z)
        self._apply(action, optimizer, report, batch)
        self.last_report = report
        _monitor.stat_add("sentinel.skipped_steps", 1)
        return False

    def feed_loss(self, loss, step: Optional[int] = None,
                  batch=None) -> Optional[AnomalyReport]:
        """Post-update loss path: feed the float the trainer already
        fetched for logging (zero extra host syncs). Runs the spike
        detector and, on anomaly, the same escalation ladder —  except the
        update is already applied, so a ``skip_step`` rung only records
        the anomaly. AnomalyGuardCallback calls this every batch.

        Returns the :class:`AnomalyReport` when anomalous, else None. A
        step already flagged by :meth:`approve_step` is not double-counted.
        """
        if step is None:
            step = max(0, self._step - 1)
        lr = self.last_report
        if lr is not None and lr.anomalous and lr.step == step:
            return None  # in-step probe already escalated this one
        if batch is None and self.batch_getter is not None:
            batch = self.batch_getter()
        loss_val = float(getattr(loss, "_data", loss))
        reasons: List[str] = []
        z = None
        if not math.isfinite(loss_val):
            reasons.append("non_finite")
            _monitor.stat_add("sentinel.nan_steps", 1)
        else:
            z, spike = self.detector.update(loss_val)
            _monitor.stat_observe("sentinel.loss_z", z)
            if spike:
                reasons.append(f"loss_spike(z={z:.2f})")
                _monitor.stat_add("sentinel.spike_steps", 1)
        if not reasons:
            self._consecutive = 0
            self.last_report = AnomalyReport(step, False, loss=loss_val, z=z)
            return None
        self._consecutive += 1
        self.anomalies += 1
        action = self.policy.decide(self._consecutive)
        report = AnomalyReport(step, True, reasons=reasons, action=action,
                               loss=loss_val, z=z)
        self._apply(action, self._optimizer, report, batch)
        self.last_report = report
        return report

    # -- actions -------------------------------------------------------------
    def _apply(self, action: str, optimizer, report: AnomalyReport, batch):
        # every escalation rung lands in the flight ring (always cheap);
        # the file dump below happens only at halt
        from ..observability import flight as _flight
        _flight.record_event("sentinel", {
            "action": action, "step": report.step,
            "reasons": list(report.reasons), "loss": report.loss,
            "z": report.z})
        if action in ("quarantine_batch", "halt"):
            quarantine_batch(self.config.quarantine_dir, report.step, batch,
                             report.reasons, loss=report.loss, z=report.z,
                             max_entries=self.config.quarantine_max)
        if action == "rollback":
            report.rolled_back_to = self._do_rollback(optimizer)
        if action == "halt":
            _monitor.stat_add("sentinel.halts", 1)
            dump_path = _flight.dump_if_armed("sentinel_halt")
            if dump_path:
                sys.stderr.write(
                    f"[sentinel] flight recording: {dump_path}\n")
            sys.stderr.write(
                f"[sentinel] halting at step {report.step}: "
                f"{', '.join(report.reasons)} (escalation exhausted after "
                f"{self._consecutive} consecutive anomalies); exiting "
                f"{self.config.halt_exit_code} so the elastic supervisor "
                f"does not restart a deterministic divergence\n")
            sys.stderr.flush()
            sys.exit(self.config.halt_exit_code)

    def _do_rollback(self, optimizer) -> Optional[int]:
        if self.rollback is None:
            if not self._warned_no_rollback:
                warnings.warn(
                    "sentinel: ladder reached 'rollback' but no rollback "
                    "adapter is configured; degrading to skip_step")
                self._warned_no_rollback = True
            return None
        restored = self.rollback.restore_newest_healthy()
        if restored is None:
            warnings.warn("sentinel: rollback found no healthy snapshot; "
                          "degrading to skip_step")
            return None
        # the diverged regime trained the detector's baseline — forget it
        self.detector.reset()
        if self.config.lr_rescale != 1.0:
            try:
                optimizer.set_lr(optimizer.get_lr()
                                 * self.config.lr_rescale)
            except RuntimeError:
                warnings.warn("sentinel: lr_rescale skipped — optimizer "
                              "uses an LRScheduler; adjust the schedule "
                              "instead")
        return restored
