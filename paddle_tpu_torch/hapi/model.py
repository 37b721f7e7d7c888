"""paddle.Model, the Keras-like training API (counterpart of
``paddle_tpu/hapi/model.py``; ``prepare``, the compiled train step and
``train_batch``/``train_batches``/``train_loop`` at ``:90-650`` are the
contract).

The JAX package compiles forward, loss, value-and-grad, clip, coupled
regularizer and optimizer update into one program per input signature
(``_build_train_step``, ``jax.jit``), kept in an LRU of 16
(``_train_fns``). The port builds the same step as a plain function
(forward and loss in training mode, ``torch.autograd.grad`` of the loss
with respect to every trainable parameter, a zero gradient for a
parameter the loss does not reach, then the optimizer's clip,
regularizer and in-place update) and wraps it in a
:class:`~paddle_tpu_torch.core.graphs.Program`, the ``jax.jit``
counterpart: on CUDA the first call for a signature runs the step
eagerly (the warm-up, and that call's result) and captures it into a
CUDA graph; every later call copies the batch into the first call's
input buffers, fills the optimizer's lr and step scalars and replays
the graph. On the CPU the same static-buffer program runs eagerly and
counts one trace per signature. Inside
``core.graphs.disable_graphs()`` the plain function runs: the eager
lane. The signature is the inputs' shapes and types and the AMP state
(``amp.state_key``), so a step captured outside ``auto_cast`` is never
replayed inside it.

A graph binds addresses: the parameters, buffers, optimizer state and
lr/step scalars are read and written in place, so new weights or state
must be copied in (``load`` and ``set_state_dict`` do), or the programs
dropped (``prepare`` and ``load`` drop them, as the reference's
``_invalidate_compiled``); a call that finds a parameter moved raises.
A program's outputs are its own buffers, read before the next call.
The model's dropout generator (``core.generator.default_generator``) is
registered with every graph, so each replay draws fresh masks.

``train_batch(update=False)`` runs the gradients-only program and adds
its gradients to each parameter's ``.grad``; the next ``update=True``
call adds its own and applies the sum through the eager
``Optimizer.step()``, as the JAX package's routing does.
``train_batches`` runs K replays of the signature's step with the lr
fixed for the call and the step number rising, and reads the K losses
once at the end; ``train_loop`` packs the trainable parameters, their
gradients and the optimizer state into one flat buffer per type and
replays one captured program that updates the flat buffers, falling back
to per-step ``train_batch`` where the reference does (an optimizer that
is not elementwise, a clip that is not global-norm, master weights).
Inputs may be NumPy arrays or tensors; they are copied to the model's
device.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: metrics and ``Dataset``/``DataLoader`` inputs (A9),
``attach_step_meter`` and a numerical sentinel on the optimizer (A8).
``prepare(amp_configs=...)`` raises as well, where the reference accepts
and ignores it: mixed precision is ``amp.auto_cast`` around
``train_batch`` (with ``amp.decorate`` for O2).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from .. import amp, framework_io
from ..core.device import DeviceLike, resolve_device
from ..core.generator import default_generator
from ..core.graphs import GraphPool, Program
from ..nn.clip import ClipGradByGlobalNorm, _clips, _sq_norm
from .callbacks import CallbackList, config_callbacks

#: compiled train steps kept per model (the reference's LRU bound)
_TRAIN_FNS_MAX = 16
#: elements of one piece of train_loop's flat update: the update's
#: temporaries are this size, not the whole buffer's
_FLAT_CHUNK = 1 << 26


class _TrainState:
    """What a model's compiled steps bind to: the graph pool and capture
    stream its step graphs share (they never run at once) and, on CUDA,
    the generator its dropout draws from, which every graph registers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph_pool = GraphPool(device)

    @property
    def generators(self):
        if self.device.type != "cuda":
            return ()
        return (default_generator(self.device),)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x))


def _listed(inputs, labels):
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    labels = labels if isinstance(labels, (list, tuple)) else (
        [labels] if labels is not None else [])
    return [_as_tensor(x) for x in inputs], [_as_tensor(y) for y in labels]


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
        self._train_state = _TrainState(self._device)
        self._train_fns = OrderedDict()
        self._invalidate_compiled()

    def attach_step_meter(self, meter=None):
        raise NotImplementedError("Model.attach_step_meter: MFU accounting "
                                  "is not ported yet (ROADMAP A8)")

    def _invalidate_compiled(self):
        """Drop every compiled program and its graphs: they hold the
        optimizer's rule and state, the loss and the parameters' places,
        so prepare() and load() must retire them."""
        for ts in self._train_fns.values():
            ts["fn"].release()
            ts["grads_fn"].release()
        if getattr(self, "_fused_loop", None) is not None:
            self._fused_loop["fn"].release()
        self._train_step_fn = None
        self._train_sig = None
        self._fused_loop_key = None
        self._fused_loop = None
        # sig -> compiled train step, least recently used first
        self._train_fns = OrderedDict()

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
        self._invalidate_compiled()

    # ------------------------------------------------------------------
    def _batch(self, inputs, labels):
        xs, ys = _listed(inputs, labels)
        return ([x.to(self._device) for x in xs],
                [y.to(self._device) for y in ys])

    def _forward(self, xs):
        preds = self.network(*xs)
        return list(preds) if isinstance(preds, (list, tuple)) else [preds]

    # -- the compiled train step ----------------------------------------
    def _get_train_step(self, sig):
        ts = self._train_fns.get(sig)
        if ts is None:
            ts = self._build_train_step(sig)
            if len(self._train_fns) >= _TRAIN_FNS_MAX:
                _, old = self._train_fns.popitem(last=False)
                old["fn"].release()
                old["grads_fn"].release()
            self._train_fns[sig] = ts
        else:
            self._train_fns.move_to_end(sig)
        self._train_step_fn = ts
        self._train_sig = sig
        return ts

    def _build_train_step(self, sig):
        """The step's programs for one signature: ``fn`` (forward, loss,
        gradients, clip, regularizer and the optimizer's in-place update;
        returns the loss) and ``grads_fn`` (forward, loss and gradients;
        returns the loss and the gradients), both
        ``raw(params, state, *inputs)`` wrapped in a ``Program``."""
        params = [p for _, p in self.network.named_parameters()]
        buffers = [b for _, b in self.network.named_buffers()]
        state = params + buffers
        trainable = [p for p in params if p.requires_grad]
        fixed_pos = [i for i, t in enumerate(state)
                     if i >= len(params) or not t.requires_grad]
        opt, loss_fn, n_x = self._optimizer, self._loss, sig[1]
        # the optimizer's positions of the trainable parameters it holds
        held = {} if opt is None else {
            id(p): i for i, p in enumerate(opt._parameter_list)}
        upd = [(held[id(p)], j) for j, p in enumerate(trainable)
               if id(p) in held]

        def value_and_grad(inputs):
            with torch.enable_grad():
                preds = self._forward(inputs[:n_x])
                loss = loss_fn(*preds, *inputs[n_x:])
                grads = torch.autograd.grad(loss, trainable,
                                            allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(trainable, grads)]

        def step(params, holder, *inputs):
            loss, grads = value_and_grad(inputs)
            opt._apply_update([i for i, _ in upd], [grads[j] for _, j in upd])
            return loss

        def grads_only(params, holder, *inputs):
            return value_and_grad(inputs)

        return {"fn": Program(step), "grads_fn": Program(grads_only),
                "state": state, "trainable": trainable,
                "fixed_pos": fixed_pos, "n_x": n_x, "inputs": None}

    def _program_params(self, ts, with_optimizer):
        """What a program reads in place, gathered anew on each call so a
        moved tensor is caught: the trainable parameters, the fixed
        buffers and, for the update, the optimizer's state and
        scalars."""
        out = [list(ts["trainable"]),
               [ts["state"][i] for i in ts["fixed_pos"]]]
        if with_optimizer:
            out.append(self._optimizer._state_tensors())
        return out

    def _static_inputs(self, ts, values):
        """The signature's input buffers (owned by the model, so a
        program copies nothing into a caller's tensor), holding
        ``values``."""
        with torch.no_grad():
            if ts["inputs"] is None:
                ts["inputs"] = [torch.empty(v.shape, dtype=v.dtype,
                                            device=self._device).copy_(v)
                                for v in values]
            else:
                for buf, v in zip(ts["inputs"], values):
                    buf.copy_(v)
        return ts["inputs"]

    def _signature(self, xs, ys, drop=0):
        return (tuple((tuple(t.shape[drop:]), str(t.dtype))
                      for t in xs + ys), len(xs), amp.state_key())

    def _accumulate(self, ts, grads):
        with torch.no_grad():
            for p, g in zip(ts["trainable"], grads):
                p.grad = g.clone() if p.grad is None else p.grad + g

    def train_batch(self, inputs, labels=None, update=True):
        """One training step on one batch; returns ``(loss, [])``. With
        ``update=False`` the gradients only accumulate into ``.grad``."""
        if self._loss is None or (update and self._optimizer is None):
            raise RuntimeError("Model.train_batch: call prepare(optimizer, "
                               "loss) first")
        xs, ys = _listed(inputs, labels)
        ts = self._get_train_step(self._signature(xs, ys))
        args = self._static_inputs(ts, xs + ys)
        self.network.train()
        opt = self._optimizer
        if not update or any(p.grad is not None for p in ts["trainable"]):
            loss, grads = ts["grads_fn"](self._program_params(ts, False),
                                         self._train_state, *args)
            self._accumulate(ts, grads)
            if update:
                # finishing an accumulation window: the eager optimizer
                # applies the carried sum (clip and regularizer inside)
                opt.step()
                opt.clear_grad()
                for p in ts["trainable"]:
                    p.grad = None
        else:
            opt._ensure_state()
            opt._fill_scalars()
            loss = ts["fn"](self._program_params(ts, True),
                            self._train_state, *args)
            opt._global_step += 1
        return float(loss), []

    # -- K steps in one call ----------------------------------------------
    def _prepare_multi_step(self, name, inputs, labels):
        """The shared preamble of train_batches and train_loop: the
        stacked ``[K, ...]`` inputs on the device, the per-step
        signature's step, the optimizer's state made; refuses pending
        accumulated gradients."""
        if self._loss is None or self._optimizer is None:
            raise RuntimeError(f"Model.{name}: call prepare(optimizer, "
                               "loss) first")
        xs, ys = self._batch(inputs, labels)
        K = int(xs[0].shape[0])
        ts = self._get_train_step(self._signature(xs, ys, drop=1))
        if any(p.grad is not None for p in ts["trainable"]):
            raise RuntimeError(
                f"{name}: pending accumulated gradients from "
                "train_batch(update=False); finish the accumulation window "
                "with train_batch(update=True) first")
        opt = self._optimizer
        opt._ensure_state()
        self.network.train()
        return ts, opt, xs, ys, K

    def _run_steps(self, fn, params, ts, opt, xs, ys, K):
        """K calls of ``fn`` on the K slices, the step number rising (the
        lr stays: nothing steps a scheduler within the call); the losses
        gathered on the device and read once."""
        losses = None
        for k in range(K):
            args = self._static_inputs(ts, [t[k] for t in xs + ys])
            opt._fill_scalars()
            loss = fn(params(), self._train_state, *args)
            if losses is None:
                losses = torch.empty(K, dtype=loss.dtype, device=loss.device)
            losses[k].copy_(loss)
            opt._global_step += 1
        return losses.tolist()

    def train_batches(self, inputs, labels=None):
        """K train steps in one call: ``inputs``/``labels`` carry a
        leading steps axis (``[K, batch, ...]`` each). Each step is a
        replay of the per-step signature's compiled step, with no host
        sync between them; the reference's scan is K steps of one program
        too, and no faster than per-step dispatch (``:277-283``). BN
        running statistics and the step counter advance as K
        :meth:`train_batch` calls would. Returns the K losses."""
        ts, opt, xs, ys, K = self._prepare_multi_step("train_batches",
                                                      inputs, labels)
        return self._run_steps(ts["fn"],
                               lambda: self._program_params(ts, True),
                               ts, opt, xs, ys, K)

    def train_loop(self, inputs, labels=None):
        """Coalesced multi-step training (reference:
        operators/coalesce_tensor_op.cc and the fused optimizers):
        ``inputs``/``labels`` carry a leading steps axis. The trainable
        parameters, their gradients and the optimizer state are packed
        once into one flat buffer per type (the parameters, their
        ``.grad`` and the state become views of it, and stay so after the
        loop, as the reference's slices of its buffer do); each step is
        one replay of a program that zeroes the flat gradients, runs
        forward and backward (which adds every gradient into its view),
        clips over the flat gradients and runs the elementwise update on
        the flat buffers. Falls back to per-step :meth:`train_batch` when
        the configuration is not elementwise-safe (``_fused_loop`` is then
        None). Returns the K losses."""
        ts, opt, xs, ys, K = self._prepare_multi_step("train_loop", inputs,
                                                      labels)
        fused = self._build_fused_loop(ts)
        if fused is None:
            return [self.train_batch([x[k] for x in xs],
                                     [y[k] for y in ys])[0]
                    for k in range(K)]
        fused["pack"]()
        try:
            return self._run_steps(fused["fn"], fused["params"], ts, opt,
                                   xs, ys, K)
        finally:
            for p in ts["trainable"]:
                p.grad = None

    def _build_fused_loop(self, ts):
        """The coalesced-buffer step for the current signature, or None
        when the optimizer or clip is not elementwise-safe on flat
        buffers: an optimizer without ``_elementwise_update``, a clip
        other than the global norm, states with differing keys or master
        weights, an update context that is not ``(coeff, ratio)``
        numbers, or a trainable parameter the optimizer does not hold."""
        if self._fused_loop_key == self._train_sig:
            return self._fused_loop
        opt = self._optimizer
        clip = opt._grad_clip
        trainable = ts["trainable"]
        held = {id(p): i for i, p in enumerate(opt._parameter_list)}
        result = None
        while True:  # one pass; break = fall back
            if not opt._elementwise_update:
                break
            if clip is not None and not isinstance(clip,
                                                   ClipGradByGlobalNorm):
                break
            if not trainable or any(id(p) not in held for p in trainable):
                break
            idx = [held[id(p)] for p in trainable]
            states = [opt._state[i] for i in idx]
            if len({tuple(sorted(s)) for s in states}) != 1 \
                    or "master" in states[0]:
                break
            ctxs = opt._param_update_ctx(trainable)
            if not (all(c is None for c in ctxs) or all(
                    isinstance(c, tuple) and len(c) == 2
                    and all(isinstance(v, (int, float)) for v in c)
                    for c in ctxs)):
                break
            regs = [opt._regularized_grad(p, None) for p in trainable]
            if not all(r is None or isinstance(r, (int, float))
                       for r in regs):
                break
            result = self._fused_loop_program(ts, opt, clip, idx, ctxs,
                                              regs, [_clips(p)
                                                     for p in trainable])
            break
        self._fused_loop_key = self._train_sig
        self._fused_loop = result
        return result

    def _fused_loop_program(self, ts, opt, clip, idx, ctxs, regs, clips):
        """Lay out one flat buffer per parameter type (parameters sorted
        by their update context, regularizer and clip flag, so each
        distinct setting is one contiguous segment, updated in pieces of
        at most ``_FLAT_CHUNK`` elements with scalar settings) and build
        the step program over it."""
        trainable, n_x = ts["trainable"], ts["n_x"]
        keys = sorted(opt._state[idx[0]])
        groups = {}
        for j, p in enumerate(trainable):
            groups.setdefault(p.dtype, []).append(j)
        layout = []          # per group: (dtype, [(j, offset, numel)], n)
        pieces = []          # (group, start, stop, ctx, reg, clip)
        for gi, (dt, js) in enumerate(groups.items()):
            js = sorted(js, key=lambda j: (repr(ctxs[j]), repr(regs[j]),
                                           clips[j]))
            offs, n = [], 0
            for j in js:
                offs.append((j, n, trainable[j].numel()))
                start, n = n, n + trainable[j].numel()
                setting = (ctxs[j], regs[j], clips[j])
                if pieces and pieces[-1][0] == gi and \
                        pieces[-1][3:] == setting and pieces[-1][2] == start:
                    pieces[-1] = (gi, pieces[-1][1], n, *setting)
                else:
                    pieces.append((gi, start, n, *setting))
            layout.append((dt, offs, n))
        pieces = [(gi, a, min(a + _FLAT_CHUNK, b), *rest)
                  for gi, start, b, *rest in pieces
                  for a in range(start, b, _FLAT_CHUNK)]
        dev = self._device
        flat_p = [torch.empty(n, dtype=dt, device=dev)
                  for dt, _, n in layout]
        flat_g = [torch.zeros_like(b) for b in flat_p]
        flat_s = [{k: torch.empty(n, dtype=opt._state[idx[offs[0][0]]][k]
                                  .dtype, device=dev) for k in keys}
                  for _, offs, n in layout]
        fixed = [ts["state"][i] for i in ts["fixed_pos"]]
        where = {j: (gi, o, n) for gi, (_, offs, _) in enumerate(layout)
                 for j, o, n in offs}

        def view(buf, j, o, n):
            return buf[o:o + n].view(trainable[j].shape)

        @torch.no_grad()
        def pack():
            """Make the parameters, their ``.grad`` and the state views of
            the flat buffers (copying them in the first time) and drop the
            step programs that read the old places."""
            moved = False
            for fp, fg, fs, (_, offs, _) in zip(flat_p, flat_g, flat_s,
                                                layout):
                for j, o, n in offs:
                    p, st = trainable[j], opt._state[idx[j]]
                    if p.data_ptr() != fp[o:o + n].data_ptr():
                        view(fp, j, o, n).copy_(p)
                        p.data = view(fp, j, o, n)
                        moved = True
                    for k in keys:
                        if st[k].data_ptr() != fs[k][o:o + n].data_ptr():
                            view(fs[k], j, o, n).copy_(st[k])
                            st[k] = view(fs[k], j, o, n)
                            moved = True
                    p.grad = view(fg, j, o, n)
            if moved:
                for other in self._train_fns.values():
                    other["fn"].release()
                    other["grads_fn"].release()

        @torch.no_grad()
        def update():
            """Clip, regularizer and the elementwise update on the flat
            buffers, in place, from the flat gradients."""
            if clip is not None:
                # the norm as the per-step clip takes it (one sum per
                # parameter, in order), so both scale alike
                sq = [_sq_norm(view(flat_g[gi], j, o, n))
                      for j, (gi, o, n) in sorted(where.items()) if clips[j]]
                if sq:
                    norm = torch.stack(sq).sum().sqrt()
                    scale = clip.clip_norm / norm.clamp_min(clip.clip_norm)
                    for gi, a, b, _, _, c in pieces:
                        if c:
                            flat_g[gi][a:b].mul_(scale.to(flat_g[gi].dtype))
            opt._memo = {}
            try:
                for gi, a, b, ctx, reg, _ in pieces:
                    p, g = flat_p[gi][a:b], flat_g[gi][a:b]
                    if reg is not None:
                        g = g + reg * p
                    opt._update_into(p, g, {k: flat_s[gi][k][a:b]
                                            for k in keys}, ctx)
            finally:
                opt._memo = None

        def fused_step(params, holder, *inputs):
            for g in flat_g:
                g.zero_()
            with torch.enable_grad():
                preds = self._forward(inputs[:n_x])
                loss = self._loss(*preds, *inputs[n_x:])
                loss.backward()
            update()
            return loss.detach()

        def params():
            return [list(trainable), flat_p, flat_g, flat_s, fixed,
                    [opt._lr_t, opt._step_t]]

        return {"fn": Program(fused_step), "pack": pack, "params": params,
                "update": update, "layout": layout, "pieces": pieces}

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
        # retire every compiled program (the reference's
        # _invalidate_compiled); the weights were copied in place
        self._invalidate_compiled()
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(framework_io.load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())
