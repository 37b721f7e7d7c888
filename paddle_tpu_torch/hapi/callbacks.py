"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``:
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``VisualDL``,
``FaultToleranceCallback``, ``AnomalyGuardCallback`` and
``config_callbacks``). The logs a ``Model`` passes hold the loss and
each metric's result under its first name; ``config_callbacks`` hands
the metric names to every callback in ``params["metrics"]``."""
from __future__ import annotations

import json
import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kw):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kw)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference: callbacks.py ProgBarLogger."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"  step {step}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"  epoch {epoch + 1} done in {dur:.1f}s - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {_fmt(v)}" for k, v in (logs or {}).items())
            print(f"  eval - {items}")


def _fmt(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ", ".join(f"{float(x):.4f}" for x in np.ravel(v)) + "]"
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor else "max"
        self.mode = mode
        self.stopped_epoch = 0
        self.wait = 0
        self.best = None
        self.stop_training = False

    def on_eval_end(self, logs=None):
        logs = logs or {}
        v = logs.get(self.monitor)
        if v is None:
            return
        v = float(np.ravel(v)[0]) if isinstance(v, (list, tuple, np.ndarray)) else float(v)
        better = (self.best is None
                  or (self.mode == "min" and v < self.best - self.min_delta)
                  or (self.mode == "max" and v > self.best + self.min_delta))
        if better:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                if self.model is not None:
                    self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference: callbacks.py LRScheduler)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Appends each train batch's logs to ``<log_dir>/metrics.jsonl``, one
    JSON object a line (``{"step": n, key: value, ...}``), which a
    dashboard can tail (reference ``:211-245``)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._step = 0

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._f = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def on_train_batch_end(self, step, logs=None):
        if self._f and logs:
            rec = {"step": self._step,
                   **{k: _scalar(v) for k, v in logs.items()}}
            self._f.write(json.dumps(rec) + "\n")
            self._step += 1

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


def _scalar(v):
    try:
        return float(np.ravel(v)[0])
    except (TypeError, ValueError):
        return str(v)


class FaultToleranceCallback(Callback):
    """Preemption-aware checkpointing for ``Model.fit`` (reference
    ``:247``).

    Arms a :class:`~paddle_tpu_torch.distributed.elastic.PreemptionGuard` (or
    shares one passed in) and polls it every batch and epoch; on preemption
    it commits a final checkpoint to ``save_dir`` and exits with the
    reserved resume code, so ``launch --elastic`` restarts the rank without
    burning the restart budget. Also fires the FaultInjector ``step`` site
    each batch so kill-mid-step scenarios are scriptable in tests
    (``PADDLE_TPU_FAULT_SPEC="step:7:crash"``).

    ``async_save=True`` routes periodic saves through the crash-consistent
    :class:`~paddle_tpu_torch.incubate.checkpoint.AsyncCheckpointer`
    (sharded format under ``save_dir/<tag>``, device snapshots, atomic
    commit, overlapped with training; the epoch rides in the health
    stamp's ``step``); the preemption save and ``on_train_end`` drain
    the writer so no snapshot is lost at exit. A ``StepWatchdog``
    (given, or from ``PADDLE_TPU_STEP_DEADLINE_S``) is armed around
    each train batch.
    """

    def __init__(self, save_dir, guard=None, save_freq=1, async_save=False,
                 step_watchdog=None):
        super().__init__()
        self.save_dir = save_dir
        self.save_freq = max(1, int(save_freq))
        self._guard = guard
        self._epoch = 0
        self._async_save = bool(async_save)
        self._ckpt = None
        self._watchdog = step_watchdog

    def _ensure_guard(self):
        if self._guard is None:
            from ..distributed.elastic import PreemptionGuard
            self._guard = PreemptionGuard()
        return self._guard

    def on_train_begin(self, logs=None):
        self._ensure_guard()
        # collective watchdog (elastic_runtime), auto-armed from the cohort
        # supervisor's PADDLE_TPU_STEP_DEADLINE_S the way the guard is from
        # PADDLE_TPU_ELASTIC: each train batch is a guarded step, so a peer
        # death mid-collective becomes exit 121 within the deadline
        from ..distributed.elastic_runtime.watchdog import maybe_auto_watchdog
        self._watchdog = maybe_auto_watchdog(self._watchdog)
        if self._async_save and self._ckpt is None:
            from ..incubate.checkpoint.async_ckpt import (
                AsyncCheckpointer, cleanup_stale_staging)
            if self.save_dir:
                os.makedirs(self.save_dir, exist_ok=True)
                cleanup_stale_staging(self.save_dir)
            self._ckpt = AsyncCheckpointer()

    def _ckpt_state(self):
        state = {"model": dict(self.model.network.state_dict())}
        if getattr(self.model, "_optimizer", None) is not None:
            state["optimizer"] = dict(self.model._optimizer.state_dict())
        return state

    def _save(self, tag, drain=False):
        if self.model is None or not self.save_dir:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        if self._ckpt is not None:
            self._ckpt.save(self._ckpt_state(),
                            os.path.join(self.save_dir, tag),
                            step=self._epoch)
            if drain:
                self._ckpt.wait()
        else:
            self.model.save(os.path.join(self.save_dir, tag))

    def restore(self, tag="latest"):
        """Load an async-saved sharded checkpoint back into the model and
        its optimizer, in place (the counterpart of ``Model.load`` for
        ``async_save=True`` saves)."""
        from ..incubate.checkpoint.auto_checkpoint import restore_into
        from ..incubate.checkpoint.sharded import load_sharded
        state = load_sharded(os.path.join(self.save_dir, tag),
                             return_tensor=False, device="cpu")
        restore_into(state, self.model.network,
                     getattr(self.model, "_optimizer", None))

    def _poll(self):
        guard = self._ensure_guard()
        if guard.preempted:
            # the final checkpoint must be durable before the exit, so the
            # async path drains the writer inside the save_fn
            guard.exit_if_preempted(
                save_fn=lambda: self._save("preempted", drain=True))

    def on_train_batch_begin(self, step, logs=None):
        if self._watchdog is not None:
            self._watchdog.arm(step)

    def on_train_batch_end(self, step, logs=None):
        if self._watchdog is not None:
            self._watchdog.disarm()
        from ..utils.resilience import fault_injector
        fault_injector().fire("step")
        self._poll()

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch
        if epoch % self.save_freq == 0:
            self._save("latest")
        self._poll()

    def on_train_end(self, logs=None):
        if self._watchdog is not None:
            self._watchdog.disarm()
        if self._ckpt is not None:
            self._ckpt.wait()


class AnomalyGuardCallback(Callback):
    """Numerical-anomaly guarding for ``Model.fit`` (reference ``:360``).

    Wires the :mod:`paddle_tpu_torch.sentinel` stack into the fit loop:

    - attaches a :class:`~paddle_tpu_torch.sentinel.Sentinel` to the
      model's optimizer, so NaN/Inf gradients are caught *before* the
      update by the on-device probe (one 8-byte fetch per guarded step)
      and the poisoned update is skipped;
    - feeds each batch's logged loss into the EWMA z-score spike detector
      (``Sentinel.feed_loss`` — no extra host syncs, the fit loop fetched
      that float anyway);
    - keeps health-stamped rollback snapshots under
      ``save_dir/snapshots`` every ``snapshot_freq`` epochs (an epoch that
      saw anomalies is stamped unhealthy, so the ``rollback`` rung never
      restores into the divergence it is escaping);
    - on escalation: quarantines the offending batch under
      ``save_dir/quarantine``, rolls back, or halts with
      ``DIVERGENCE_EXIT_CODE`` per the configured ladder.
    """

    def __init__(self, save_dir=None, config=None, snapshot_freq=1,
                 keep_last=2, attach_optimizer=True, async_snapshots=False):
        super().__init__()
        self.save_dir = save_dir
        self.snapshot_freq = max(1, int(snapshot_freq))
        self.keep_last = keep_last
        self.attach_optimizer = attach_optimizer
        self.async_snapshots = bool(async_snapshots)
        self._config = config
        self.sentinel = None
        self.rollback = None
        self._epoch_anomalies = 0

    def on_train_begin(self, logs=None):
        from ..sentinel import (Sentinel, SentinelConfig, CheckpointRollback)
        if self.sentinel is None:
            cfg = self._config
            if cfg is None:
                qdir = (os.path.join(self.save_dir, "quarantine")
                        if self.save_dir else None)
                cfg = SentinelConfig(quarantine_dir=qdir)
            if self.save_dir:
                self.rollback = CheckpointRollback(
                    os.path.join(self.save_dir, "snapshots"),
                    model=self.model.network,
                    optimizer=self.model._optimizer,
                    keep_last=self.keep_last,
                    async_save=self.async_snapshots)
            self.sentinel = Sentinel(cfg, rollback=self.rollback)
            self.sentinel.batch_getter = \
                lambda: getattr(self.model, "_last_batch", None)
        if self.attach_optimizer and self.model._optimizer is not None:
            self.sentinel.attach(self.model._optimizer)

    def on_epoch_begin(self, epoch, logs=None):
        if self.sentinel is not None:
            self._epoch_anomalies = self.sentinel.anomalies

    def on_train_batch_end(self, step, logs=None):
        loss = (logs or {}).get("loss")
        if self.sentinel is not None and loss is not None:
            loss = loss[0] if isinstance(loss, (list, tuple)) else loss
            self.sentinel.feed_loss(np.asarray(loss).reshape(-1)[0])

    def on_epoch_end(self, epoch, logs=None):
        if self.rollback is None or epoch % self.snapshot_freq != 0:
            return
        healthy = (self.sentinel.anomalies == self._epoch_anomalies)
        self.rollback.snapshot(
            self.sentinel._step, healthy=healthy,
            reason=None if healthy else
            f"epoch {epoch} saw "
            f"{self.sentinel.anomalies - self._epoch_anomalies} anomalies")

    def on_train_end(self, logs=None):
        if self.rollback is not None:
            self.rollback.wait()  # async snapshots must land before exit


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst
