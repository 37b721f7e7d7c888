"""paddle.Model, the Keras-like training API (counterpart of
``paddle_tpu/hapi/model.py``; ``Model.prepare`` and ``train_batch`` at
``:139-217`` and ``:563-650`` are the contract).

The JAX package compiles forward, loss, backward and the optimizer update
into one program per input signature. The port runs the same step
eagerly: forward and loss in training mode, ``loss.backward()`` (which
accumulates into each parameter's ``.grad``), then the optimizer's
``step()``: clip, coupled regularizer, update, in that order. A trainable
parameter the loss does not reach gets a zero gradient, as the JAX step's
``value_and_grad`` gives it. ``train_batch(update=False)`` only
accumulates; the next ``update=True`` call adds its own gradients and
applies the sum, as the JAX package's eager path does. Inputs may be NumPy
arrays or tensors; they move to the model's device.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: metrics and ``Dataset``/``DataLoader`` inputs (A9),
``train_batches`` and ``train_loop`` (A4), ``attach_step_meter`` and a
numerical sentinel on the optimizer (A8). ``prepare(amp_configs=...)``
raises as well, where the reference accepts and ignores it: mixed
precision is ``amp.auto_cast`` around ``train_batch`` (with
``amp.decorate`` for O2), which the step reads on every call.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import framework_io
from ..core.device import DeviceLike, resolve_device
from .callbacks import CallbackList, config_callbacks


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None,
                 *, device: DeviceLike = None):
        self._device = resolve_device(device)
        for name, p in network.named_parameters():
            if p.device != self._device:
                raise ValueError(
                    f"Model on {self._device}: parameter {name} is on "
                    f"{p.device}; build the network on the same device")
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self.stop_training = False

    def attach_step_meter(self, meter=None):
        raise NotImplementedError("Model.attach_step_meter: MFU accounting "
                                  "is not ported yet (ROADMAP A8)")

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise NotImplementedError("Model.prepare: metrics are not "
                                      "ported yet (ROADMAP A9)")
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare: amp_configs is not taken; the reference "
                "accepts and ignores it, and AMP is entered through "
                "amp.auto_cast / GradScaler / decorate (ROADMAP A4)")
        if getattr(optimizer, "_sentinel", None) is not None:
            raise NotImplementedError("Model.prepare: the numerical "
                                      "sentinel is not ported yet "
                                      "(ROADMAP A8)")
        self._optimizer = optimizer
        self._loss = loss

    # ------------------------------------------------------------------
    def _to_device(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self._device)

    def _batch(self, inputs, labels):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else (
            [labels] if labels is not None else [])
        return ([self._to_device(x) for x in inputs],
                [self._to_device(y) for y in labels])

    def _forward(self, xs):
        preds = self.network(*xs)
        return list(preds) if isinstance(preds, (list, tuple)) else [preds]

    def train_batch(self, inputs, labels=None, update=True):
        """One training step on one batch; returns ``(loss, [])``. With
        ``update=False`` the gradients only accumulate into ``.grad``."""
        if self._loss is None or (update and self._optimizer is None):
            raise RuntimeError("Model.train_batch: call prepare(optimizer, "
                               "loss) first")
        xs, ys = self._batch(inputs, labels)
        self.network.train()
        loss = self._loss(*self._forward(xs), *ys)
        loss.backward()
        if update:
            opt = self._optimizer
            for p in opt._parameter_list:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            opt.clear_grad()
        return float(loss.detach()), []

    def train_batches(self, inputs, labels=None):
        raise NotImplementedError("Model.train_batches: multi-step training "
                                  "in one call is not ported yet "
                                  "(ROADMAP A4)")

    def train_loop(self, inputs, labels=None):
        raise NotImplementedError("Model.train_loop: coalesced multi-step "
                                  "training is not ported yet (ROADMAP A4)")

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """Forward and loss in eval mode; returns ``(loss or None, [])``."""
        xs, ys = self._batch(inputs, labels)
        self.network.eval()
        preds = self._forward(xs)
        if self._loss is None or not ys:
            return None, []
        return float(self._loss(*preds, *ys)), []

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs in eval mode (one tensor, or a list)."""
        xs, _ = self._batch(inputs, None)
        self.network.eval()
        out = self._forward(xs)
        return out[0] if len(out) == 1 else out

    # ------------------------------------------------------------------
    @staticmethod
    def _batches(data, what):
        if isinstance(data, (torch.utils.data.Dataset,
                             torch.utils.data.DataLoader)):
            raise NotImplementedError(
                f"Model.{what}: Dataset/DataLoader inputs are not ported "
                "yet (ROADMAP A9); pass an iterable of batches")
        return data

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return [batch[0]], []
        return [batch], []

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train over an iterable of batches (each ``[*inputs, label]``)
        for ``epochs``, with the callbacks of :func:`config_callbacks`
        (the ``LRScheduler`` callback steps the optimizer's scheduler
        after every batch)."""
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "Model.fit: accumulate_grad_batches is not taken (the "
                "reference accepts and ignores it); use "
                "train_batch(update=False)")
        loader = self._batches(train_data, "fit")
        eval_loader = self._batches(eval_data, "fit") \
            if eval_data is not None else None
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir, metrics=[])
        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                xs, ys = self._split_batch(batch)
                loss, _ = self.train_batch(xs, ys)
                logs = {"loss": loss}
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=verbose,
                              callbacks=cbks.callbacks, _inner=True)
            if self.stop_training or (num_iters is not None
                                      and it >= num_iters):
                break
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _inner=False):
        """Mean loss over an iterable of batches, as ``{"loss": ...}``."""
        losses: List[float] = []
        for batch in self._batches(eval_data, "evaluate"):
            xs, ys = self._split_batch(batch)
            loss, _ = self.eval_batch(xs, ys)
            if loss is not None:
                losses.append(loss)
        logs = {"loss": float(np.mean(losses))} if losses else {}
        if callbacks is not None and _inner:
            CallbackList(callbacks).on_eval_end(logs)
        elif verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs over an iterable of batches, as NumPy
        arrays (one per batch, or a list per batch for several
        outputs)."""
        outputs = []
        for batch in self._batches(test_data, "predict"):
            xs, _ = self._split_batch(batch)
            out = self.predict_batch(xs)
            outputs.append(out.cpu().numpy() if isinstance(out, torch.Tensor)
                           else [o.cpu().numpy() for o in out])
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs, 0)]
        return outputs

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (and ``path.pdopt`` when training) in the
        ``paddle.save`` format both packages read."""
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework_io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = framework_io.load(path + ".pdparams")
        self.network.load_state_dict(state, strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(framework_io.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())
