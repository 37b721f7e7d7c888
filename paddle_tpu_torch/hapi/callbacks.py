"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``:
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``VisualDL`` and
``config_callbacks``). The logs a ``Model`` passes hold the loss and
each metric's result under its first name; ``config_callbacks`` hands
the metric names to every callback in ``params["metrics"]``.
``FaultToleranceCallback`` and ``AnomalyGuardCallback`` are not ported
yet (ROADMAP A8)."""
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
