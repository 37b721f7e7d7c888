"""paddle.Model, the Keras-like training API (counterpart of
``paddle_tpu/hapi/model.py``: ``prepare``, the compiled train step,
``train_batch``/``train_batches``/``train_loop``, the compiled eval and
predict programs, ``fit``/``evaluate``/``predict`` over datasets and
loaders, and ``summary``).

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

With metrics attached (``prepare(metrics=...)``), the train program
also returns the predictions, into its own output buffers, and
``train_batch`` and ``eval_batch`` return each metric's ``update`` of
its ``compute`` on them (the reference's ``want_preds``); without
metrics the predictions are not kept. ``train_batches`` and
``train_loop`` refuse metrics, as the reference's do.

``eval_batch`` and ``predict_batch`` run a compiled program too: one
per signature and form (with the loss, without it, or predict), in an
LRU of 64 (``_eval_fns``, the reference's ``_eval_fns``), captured in
eval mode (the network is switched to eval outside the capture) and
dropped with the train programs. ``predict_batch`` returns copies of
the program's outputs.

``fit``, ``evaluate`` and ``predict`` take a ``io.Dataset`` (made into
an ``io.DataLoader`` on the model's device with ``batch_size``,
``shuffle`` and ``num_workers``), an ``io.DataLoader`` or any iterable
of batches, and log the reference's keys: the loss, then each metric's
``accumulate()`` under its first name.

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

``attach_step_meter()`` opts into live MFU
(``observability.stepmeter``): at a signature's first metered step its
forward and gradients run once eagerly under the FLOP counter, with the
dropout generator and the buffers put back (the optimizer's update is
element-wise, which the counter does not count), and every metered
``train_batch`` publishes ``train.mfu``, ``train.flops_per_step`` and
``train.step_ms`` over the step's wall (the loss fetch synchronises).
With a meter or tracing on, ``train_batch`` is a ``train/step`` span; a
program's first call is ``jit/compile``; an exception out of ``fit``
records the ``train_loop_exception`` flight event and dumps the flight
recorder when it is armed.

An optimizer guarded by a numerical sentinel (``sentinel.Sentinel``
attached) takes the reference's sentinel route in ``train_batch``: the
captured gradients program (``grads_fn``) runs, each trainable
parameter's ``.grad`` is bound to that program's own gradient buffer
(the same tensors every replay, so the sentinel's captured probe reads
them in place), the sentinel ``observe``s the device loss, the eager
``Optimizer.step()`` asks it to approve the update (a refused step
changes nothing), and the gradients are cleared. The route leaves the
fused captured step: the update runs eagerly. ``fit`` keeps the batch in
``_last_batch`` for the sentinel's quarantine dumps. ``train_batches``
and ``train_loop`` do not consult the sentinel, as the reference's do
not. A rollback copies the restored state into the live tensors in
place, so the next replay reads it.

``prepare(amp_configs=...)`` raises ``NotImplementedError``, where the
reference accepts and ignores it: mixed precision is ``amp.auto_cast``
around ``train_batch`` (with ``amp.decorate`` for O2).
"""
from __future__ import annotations

import itertools
import os
import time
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from .. import amp, framework_io
from ..core.device import DeviceLike, resolve_device
from ..core.generator import default_generator
from ..core.tensor import Tensor
from ..core.graphs import (GraphPool, Program, disable_graphs,
                           graphs_enabled)
from ..distributed.mesh import full, is_dtensor, reduce_grad
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..nn.clip import ClipGradByGlobalNorm, _clips, _sq_norm
from ..observability import flight as _flight
from ..observability import tracer as _otrace
from .callbacks import CallbackList, config_callbacks

#: compiled train steps kept per model (the reference's LRU bound)
_TRAIN_FNS_MAX = 16
#: compiled eval and predict programs kept per model (the reference's)
_EVAL_FNS_MAX = 64
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
    if isinstance(x, Tensor):
        return x._data
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
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._step_meter = None         # opt-in MFU (attach_step_meter)
        self._train_state = _TrainState(self._device)
        self._train_fns = OrderedDict()
        self._eval_fns = OrderedDict()
        self._invalidate_compiled()

    def attach_step_meter(self, meter=None):
        """Opt into live MFU: every ``train_batch`` publishes
        ``train.mfu``, ``train.flops_per_step`` and ``train.step_ms``
        (default: a ``StepMeter(prefix="train")`` against the peak of the
        model's device). The FLOPs are counted once per train-step
        signature. Returns the meter."""
        if meter is None:
            from ..observability.stepmeter import StepMeter
            meter = StepMeter(prefix="train", device=self._device)
        self._step_meter = meter
        return meter

    def _count_step_flops(self, ts, args):
        """FLOPs of one step of this signature (MAC convention): its
        forward and gradients run once eagerly under the counter, never
        inside a capture. What that run moves is put back: the dropout
        generator's state and the buffers (BatchNorm's statistics)."""
        from ..observability import stepmeter as _sm
        gen = default_generator(self._device)
        gen_state = gen.get_state()
        buffers = [b for _, b in self.network.named_buffers()]
        saved = [b.detach().clone() for b in buffers]
        try:
            with _otrace.span("observability/cost_analysis"):
                return _sm.compiled_flops(ts["value_and_grad"], args)
        finally:
            gen.set_state(gen_state)
            with torch.no_grad():
                for b, v in zip(buffers, saved):
                    b.copy_(v)

    def _invalidate_compiled(self):
        """Drop every compiled program and its graphs: they hold the
        optimizer's rule and state, the loss and the parameters' places,
        so prepare() and load() must retire them."""
        for ts in self._train_fns.values():
            ts["fn"].release()
            ts["grads_fn"].release()
        for ef in self._eval_fns.values():
            ef["fn"].release()
        if getattr(self, "_fused_loop", None) is not None:
            self._fused_loop["fn"].release()
        self._train_step_fn = None
        self._train_sig = None
        self._fused_loop_key = None
        self._fused_loop = None
        # sig -> compiled train step, least recently used first
        self._train_fns = OrderedDict()
        # (sig, form) -> compiled eval or predict program, the same way
        self._eval_fns = OrderedDict()

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare: amp_configs is not taken; the reference "
                "accepts and ignores it, and AMP is entered through "
                "amp.auto_cast / GradScaler / decorate (ROADMAP A4)")
        self._optimizer = optimizer
        self._loss = loss
        self._invalidate_compiled()
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)

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
        # the predictions are an extra write a step (a [B, S, vocab]
        # logits tensor for an LM head): kept only for metrics
        want_preds = sig[3]
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
            preds = [p.detach() for p in preds] if want_preds else []
            # on a mesh: the loss's global value, each gradient laid out
            # as its parameter (the data-parallel reduction, in the step)
            return full(loss.detach()), preds, [
                torch.zeros_like(p) if g is None else reduce_grad(p, g)
                for p, g in zip(trainable, grads)]

        def step(params, holder, *inputs):
            loss, preds, grads = value_and_grad(inputs)
            opt._apply_update([i for i, _ in upd], [grads[j] for _, j in upd])
            return loss, preds

        def grads_only(params, holder, *inputs):
            return value_and_grad(inputs)

        return {"fn": Program(step, name="train_step"),
                "grads_fn": Program(grads_only, name="train_grads"),
                "value_and_grad": value_and_grad,
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
                ts["inputs"] = [
                    torch.empty_like(v).copy_(v) if is_dtensor(v) else
                    torch.empty(v.shape, dtype=v.dtype,
                                device=self._device).copy_(v)
                    for v in values]
            else:
                for buf, v in zip(ts["inputs"], values):
                    buf.copy_(v)
        return ts["inputs"]

    def _signature(self, xs, ys, drop=0):
        return (tuple((tuple(t.shape[drop:]), str(t.dtype))
                      for t in xs + ys), len(xs), amp.state_key(),
                bool(self._metrics))

    def _accumulate(self, ts, grads):
        with torch.no_grad():
            for p, g in zip(ts["trainable"], grads):
                p.grad = g.clone() if p.grad is None else p.grad + g

    def train_batch(self, inputs, labels=None, update=True):
        """One training step on one batch; returns ``(loss, metrics)``,
        each metric's ``update`` on this batch's predictions. With
        ``update=False`` the gradients only accumulate into ``.grad``."""
        meter = self._step_meter
        if meter is None and not _otrace._ENABLED[0]:
            return self._train_batch_impl(inputs, labels, update)
        t0 = time.perf_counter()
        with _otrace.span("train/step"):
            out = self._train_batch_impl(inputs, labels, update)
        if meter is not None:
            # the impl's float(loss) synchronises: the wall is the step's
            ts = self._train_step_fn
            meter.step(time.perf_counter() - t0,
                       flops=ts.get("flops") if ts else None)
        return out

    @property
    def lane(self) -> str:
        """Where ``train_batch`` runs its step: "graphed" (a captured CUDA
        graph, replayed), "eager" (the plain function on CUDA, inside
        ``disable_graphs`` or for a model that cannot be captured: see
        :attr:`lane_reason`) or "cpu"."""
        if self._device.type != "cuda":
            return "cpu"
        if not graphs_enabled() or self.lane_reason is not None:
            return "eager"
        return "graphed"

    @property
    def lane_reason(self):
        """Why a CUDA model runs eagerly by itself, or None: a model laid
        out on a gloo mesh (gloo's collectives cannot be captured into a
        CUDA graph)."""
        p = next(iter(self.network.parameters()), None)
        if self._device.type != "cuda" or p is None or not is_dtensor(p):
            return None
        import torch.distributed as dist
        backend = dist.get_backend(p.device_mesh.get_group(0))
        if backend != "nccl":
            return (f"the model is laid out on a {backend} mesh, whose "
                    f"collectives a CUDA graph cannot capture")
        return None

    def _train_batch_impl(self, inputs, labels, update):
        if self.lane_reason is not None and graphs_enabled():
            with disable_graphs():
                return self._train_batch_impl(inputs, labels, update)
        if self._loss is None or (update and self._optimizer is None):
            raise RuntimeError("Model.train_batch: call prepare(optimizer, "
                               "loss) first")
        xs, ys = _listed(inputs, labels)
        ts = self._get_train_step(self._signature(xs, ys))
        args = self._static_inputs(ts, xs + ys)
        self.network.train()
        if self._step_meter is not None and "flops" not in ts:
            # once per signature, before (never inside) its capture
            ts["flops"] = self._count_step_flops(ts, args)
            self._step_meter.set_flops_per_step(ts["flops"])
        opt = self._optimizer
        sentinel = getattr(opt, "_sentinel", None) if update else None
        pending = any(p.grad is not None for p in ts["trainable"])
        if not update or pending or sentinel is not None:
            loss, preds, grads = ts["grads_fn"](
                self._program_params(ts, False), self._train_state, *args)
            if pending or not update:
                self._accumulate(ts, grads)
            else:
                # the sentinel route: .grad is the program's own buffer,
                # the same tensor every replay, which the probe reads (a
                # first call on CUDA returned its warm-up's tensors: their
                # values go into those buffers; the eager lane has none)
                bound = ts["grads_fn"].outputs(self._train_state)
                static = grads if bound is None else bound[2]
                with torch.no_grad():
                    for s, g in zip(static, grads):
                        if s is not g:
                            s.copy_(g)
                for p, g in zip(ts["trainable"], static):
                    p.grad = g
            if update:
                # the eager optimizer applies the gradients (clip and
                # regularizer inside), after the sentinel's approval
                if sentinel is not None:
                    sentinel.observe(loss=loss)
                opt.step()
                opt.clear_grad()
                for p in ts["trainable"]:
                    p.grad = None
        else:
            opt._ensure_state()
            opt._fill_scalars()
            loss, preds = ts["fn"](self._program_params(ts, True),
                                   self._train_state, *args)
            opt._global_step += 1
        return float(loss), self._update_metrics(preds, ys)

    def _update_metrics(self, preds, labels):
        """Each metric's ``update`` of its ``compute`` on ``preds`` (read
        before the program's next call overwrites them)."""
        out = []
        for m in self._metrics:
            r = m.compute(*preds, *labels)
            out.append(m.update(r if not isinstance(r, tuple) else r[0]))
        return out

    # -- K steps in one call ----------------------------------------------
    def _prepare_multi_step(self, name, inputs, labels):
        """The shared preamble of train_batches and train_loop: the
        stacked ``[K, ...]`` inputs on the device, the per-step
        signature's step, the optimizer's state made; refuses pending
        accumulated gradients."""
        if self._loss is None or self._optimizer is None:
            raise RuntimeError(f"Model.{name}: call prepare(optimizer, "
                               "loss) first")
        if self._metrics:
            raise ValueError(
                f"{name}: detach metrics (prepare(..., metrics=None)); "
                "per-step predictions are not materialized")
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
            if isinstance(loss, (tuple, list)):
                loss = loss[0]
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
        if any(is_dtensor(p) for p in self.network.parameters()):
            raise NotImplementedError(
                "Model.train_loop packs the parameters, gradients and "
                "optimizer state into one flat buffer a type, and a model "
                "laid out on a mesh holds DTensor shards that cannot be "
                "views of one buffer: use train_batch or train_batches")
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
                for other in self._eval_fns.values():
                    other["fn"].release()

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

    # -- the compiled eval and predict programs ---------------------------
    def _get_eval_step(self, key, with_loss):
        ef = self._eval_fns.get(key)
        if ef is None:
            ef = self._build_eval_step(key[0][1], with_loss)
            if len(self._eval_fns) >= _EVAL_FNS_MAX:
                _, old = self._eval_fns.popitem(last=False)
                old["fn"].release()
            self._eval_fns[key] = ef
        else:
            self._eval_fns.move_to_end(key)
        return ef

    def _build_eval_step(self, n_x, with_loss):
        """``raw(params, holder, *inputs) -> (preds, loss)`` in eval mode
        and without gradients, as a ``Program``: the forward, and the
        loss when ``with_loss`` (a zero otherwise)."""
        params = [p for _, p in self.network.named_parameters()]
        buffers = [b for _, b in self.network.named_buffers()]
        loss_fn = self._loss

        @torch.no_grad()
        def ev(params, holder, *inputs):
            preds = self._forward(inputs[:n_x])
            if with_loss:
                loss = loss_fn(*preds, *inputs[n_x:])
            else:
                loss = torch.zeros((), device=self._device)
            return preds, loss

        return {"fn": Program(ev), "params": [params, buffers],
                "inputs": None}

    def _run_eval(self, xs, ys, form):
        key = (self._signature(xs, ys)[:3], form)
        ef = self._get_eval_step(key, form == "loss")
        args = self._static_inputs(ef, xs + ys)
        # the mode is switched outside the program: it is captured in
        # eval mode and replays eval-mode kernels
        self.network.eval()
        return ef["fn"](ef["params"], self._train_state, *args)

    def eval_batch(self, inputs, labels=None):
        """Forward and loss in eval mode through the signature's compiled
        program; returns ``(loss or None, metrics)``."""
        xs, ys = _listed(inputs, labels)
        with_loss = self._loss is not None and bool(ys)
        preds, loss = self._run_eval(xs, ys,
                                     "loss" if with_loss else "forward")
        metrics = self._update_metrics(preds, ys)
        return (float(loss) if with_loss else None), metrics

    def predict_batch(self, inputs):
        """The network's outputs in eval mode (one tensor, or a list),
        copied out of the signature's compiled program."""
        xs, _ = _listed(inputs, None)
        preds, _ = self._run_eval(xs, [], "predict")
        out = [p.clone() for p in preds]
        return out[0] if len(out) == 1 else out

    # ------------------------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, num_workers):
        """A ``Dataset`` as a ``DataLoader`` on the model's device; a
        ``DataLoader`` or any other iterable of batches as it is."""
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, device=self._device)
        return data

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return [batch[0]], []
        return [batch], []

    def _metric_logs(self, logs, values):
        for m, r in zip(self._metrics, values):
            name = m.name()
            logs[name if isinstance(name, str) else name[0]] = r
        return logs

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train over a ``Dataset``, a ``DataLoader`` or an iterable of
        batches (each ``[*inputs, label]``) for ``epochs``, evaluating on
        ``eval_data`` every ``eval_freq`` epochs, with the callbacks of
        :func:`config_callbacks` (the ``LRScheduler`` callback steps the
        optimizer's scheduler after every batch). Each batch's logs hold
        the loss and every metric's result on the batch."""
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "Model.fit: accumulate_grad_batches is not taken (the "
                "reference accepts and ignores it); use "
                "train_batch(update=False)")
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir,
                                metrics=[m.name() for m in self._metrics])
        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        logs = {}
        try:
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                for step, batch in enumerate(loader):
                    cbks.on_train_batch_begin(step)
                    xs, ys = self._split_batch(batch)
                    self._last_batch = (xs, ys)  # for quarantine dumps
                    loss, metrics = self.train_batch(xs, ys)
                    logs = self._metric_logs({"loss": loss}, metrics)
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
        except Exception as e:
            # the post-mortem timeline of the guarded loop; a dump only
            # when the flight recorder is armed
            _flight.record_event("train_loop_exception",
                                 {"error": f"{type(e).__name__}: {e}",
                                  "iteration": it})
            _flight.dump_if_armed("train_loop_exception")
            raise
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _inner=False):
        """The mean loss and each metric's ``accumulate()`` over a
        ``Dataset``, ``DataLoader`` or iterable of batches."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        losses: List[float] = []
        for batch in loader:
            xs, ys = self._split_batch(batch)
            loss, _ = self.eval_batch(xs, ys)
            if loss is not None:
                losses.append(loss)
        logs = {"loss": float(np.mean(losses))} if losses else {}
        self._metric_logs(logs, [m.accumulate() for m in self._metrics])
        if callbacks is not None and _inner:
            CallbackList(callbacks).on_eval_end(logs)
        elif verbose:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs over a ``Dataset``, ``DataLoader`` or
        iterable of batches, as NumPy arrays: one per batch (a list per
        batch for several outputs), or with ``stack_outputs`` and one
        output, ``[all batches concatenated]``."""
        loader = self._as_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
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

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net: torch.nn.Module, input_size=None, dtypes=None):
    """A table of the sublayers with the parameters and buffers each holds
    itself, and the totals (reference ``:875-913``); returns
    ``{"total_params", "trainable_params"}``. ``input_size`` and
    ``dtypes`` are not read, as in the reference."""
    rows = []
    for name, layer in net.named_modules():
        if name == "":
            continue
        n = sum(t.numel() for t in itertools.chain(
            layer._parameters.values(), layer._buffers.values())
            if t is not None)
        rows.append((name, type(layer).__name__, n))
    seen = set()
    total = trainable = 0
    for _, p in net.named_parameters():
        if id(p) not in seen:
            seen.add(id(p))
            total += p.numel()
            trainable += p.numel() if p.requires_grad else 0
    for _, b in net.named_buffers():
        if id(b) not in seen:
            seen.add(id(b))
            total += b.numel()
    print("-" * 64)
    print(f"{'Layer':<36}{'Type':<18}{'Params':>10}")
    print("=" * 64)
    for name, kind, n in rows:
        print(f"{name:<36}{kind:<18}{n:>10}")
    print("=" * 64)
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    print("-" * 64)
    return {"total_params": total, "trainable_params": trainable}
