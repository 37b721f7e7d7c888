"""The optimizer base, its eleven rules and ``ExponentialMovingAverage``
(counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer defines one update rule ``_update(p, g, state, lr, step,
ctx) -> (p, state)``; :meth:`Optimizer.step` applies it parameter
by parameter in the JAX package's order: clip the gradients
(``grad_clip``), add the coupled regularizer ``coeff * p``
(:meth:`Optimizer._regularized_grad`), cast the gradient to the
parameter's type, update. The JAX package fuses the whole step into one
jitted program and rebinds the results; here each rule runs the
reference's arithmetic as the in-place forms of its operations, in its
order, on the parameter and its state tensors (moments, velocity,
masters; an O2 master is cast back into its bfloat16 parameter), so
they keep their addresses: a CUDA graph that captured the step
(``hapi.Model``) reads and writes the optimizer's own tensors, and
:meth:`state_dict` returns live tensors. The learning rate and the step
counter are two float32 scalars on the parameters' device (``_lr_t``,
``_step_t``), filled from :meth:`get_lr` and ``_global_step + 1`` before
each update (a fill is a launch, not a host sync; a captured step reads
them where they are). Adam's bias correction is ``1 - beta ** step``.
AdamW applies its decoupled decay ``p * (1 - lr * ratio * coeff)`` before
the Adam update, with ``ctx = (coeff or 0, ratio)`` from
``apply_decay_param_fun(name)`` and ``lr_ratio(p)``. A torch tensor
cannot carry paddle's ``p.name``, so ``parameters`` may hold ``(name,
parameter)`` pairs, as ``module.named_parameters()`` gives them; a bare
parameter's name is "" (the JAX package passes ``p.name or ""``, which is
"" for every parameter a layer creates unnamed). ``_elementwise_update``
marks a rule that is elementwise in ``(p, g, state)`` (SGD, Momentum,
Adam and AdamW, as in the reference), so ``Model.train_loop`` may run it
on coalesced flat buffers; the other seven leave it False and
``train_loop`` falls back to per-step ``train_batch`` for them.

Written in place, a rule reads every old value before it overwrites it
(Adadelta's update reads the old ``avg_sq_update``, Ftrl's ``sigma`` the
old ``squared`` and its ``linear`` the old parameter, Lamb's and
LarsMomentum's norms the parameter before it moves). Lamb's trust ratio
and LarsMomentum's local lr are ``torch.where`` on float32 norms held on
the device, never a Python branch, so a captured step holds them.

``state_dict`` keys are the JAX package's (``param_{i}.moment1``,
``.moment2``, ``.velocity``, ``.master``, ``.moment``, ``.inf_norm``,
``.avg_sq_grad``, ``.avg_sq_update``, ``.mean_square``, ``.momentum``,
``.mean_grad``, ``.squared``, ``.linear``, ``global_step``,
``LR_Scheduler``), ``i`` being the parameter's position in
``parameters``, so a ``.pdopt`` file moves between the packages;
:meth:`set_state_dict` copies into the live state in place. Like every
entry point of the port, an optimizer lives on CUDA unless ``device``
says otherwise, and refuses parameters elsewhere.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 device: DeviceLike = None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        self._parameter_list, self._names = [], {}
        for item in parameters:
            name, p = item if isinstance(item, tuple) else ("", item)
            self._parameter_list.append(p)
            self._names[id(p)] = name
        self._device = resolve_device(device)
        for p in self._parameter_list:
            if p.device != self._device:
                raise ValueError(
                    f"optimizer on {self._device} got a parameter on "
                    f"{p.device}; pass device= to match the model")
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        # state by position in the parameter list
        self._state: Dict[int, dict] = {}
        self._global_step = 0
        # the lr and step (float32 scalars on the device) and, during one
        # update, the scalars derived from them (see _scalar)
        self._lr_t = self._step_t = None
        self._memo = None
        # set by sentinel.Sentinel.attach: step() asks it first
        self._sentinel = None

    # -- lr -------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- state ----------------------------------------------------------
    def _ensure_state(self):
        """Make the state of every parameter and the lr and step scalars,
        once (a captured step must find them made: state made during a
        capture would live in the graph's memory pool)."""
        if not self._state:
            for i, p in enumerate(self._parameter_list):
                self._state[i] = self._init_state(p)
        if self._lr_t is None:
            self._lr_t = torch.zeros((), dtype=torch.float32,
                                     device=self._device)
            self._step_t = torch.zeros((), dtype=torch.float32,
                                       device=self._device)

    def _fill_scalars(self):
        """Write :meth:`get_lr` and the step number, ``_global_step + 1``,
        into the device scalars the update reads."""
        self._lr_t.fill_(self.get_lr())
        self._step_t.fill_(self._global_step + 1)

    def _state_tensors(self):
        """Every state tensor and the lr and step scalars: what a captured
        step reads and writes in place."""
        return [self._state[i] for i in range(len(self._parameter_list))] \
            + [self._lr_t, self._step_t]

    def _init_state(self, p) -> dict:
        return {}

    def state_dict(self):
        """Moments (and masters) by ``param_{i}.{name}``, the global step
        and the LR scheduler's state."""
        self._ensure_state()
        out = {}
        for i in range(len(self._parameter_list)):
            for k, v in self._state[i].items():
                out[f"param_{i}.{k}"] = v
        out["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load :meth:`state_dict` output, from this package or the JAX
        package (values may be tensors or arrays), copied into the live
        state in place."""
        self._ensure_state()
        for i in range(len(self._parameter_list)):
            cur = self._state[i]
            for k in cur:
                key = f"param_{i}.{k}"
                if key in state:
                    v = state[key]
                    if not isinstance(v, torch.Tensor):
                        v = torch.as_tensor(np.asarray(v))
                    with torch.no_grad():
                        cur[k].copy_(v.reshape(cur[k].shape))
        self._global_step = int(state.get("global_step", self._global_step))
        if "LR_Scheduler" in state and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    # -- update rule (override) -----------------------------------------
    #: True when ``_update`` is elementwise in ``(p, g, state)``, so it may
    #: run on coalesced flat buffers (``Model.train_loop``)
    _elementwise_update = False

    def _update(self, p, g, state, lr, step, ctx=None):
        raise NotImplementedError

    def _scalar(self, key, make):
        """The scalar tensor ``make()`` (from the lr or step tensors),
        made once per update and shared by every parameter's rule; made
        anew outside an update."""
        if self._memo is None:
            return make()
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = make()
        return v

    def _regularized_grad(self, p, g):
        """The coupled regularizer's coefficient for ``p`` (the caller
        adds ``coeff * p`` to the gradient), or None: the parameter's own
        ``regularizer`` first, else ``weight_decay`` unless the optimizer
        decays decoupled (AdamW)."""
        reg = getattr(p, "regularizer", None)
        wd = self._weight_decay
        coeff = None
        if reg is not None and getattr(reg, "_coeff", None):
            coeff = reg._coeff
        elif isinstance(wd, (int, float)) and \
                not getattr(self, "_decoupled_wd", False):
            coeff = float(wd)
        elif wd is not None and hasattr(wd, "_coeff") and \
                not getattr(self, "_decoupled_wd", False):
            coeff = wd._coeff
        return coeff

    def _param_update_ctx(self, params):
        """Per-parameter context passed to ``_update`` (AdamW: decay
        coefficient and lr ratio)."""
        return [None] * len(params)

    # -- step -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient and requires
        one: clip, coupled regularizer, update. An attached sentinel
        (``sentinel.Sentinel.attach``) approves the step first; a refused
        step changes nothing (parameters, state, step count, scalars)."""
        if self._sentinel is not None and \
                not self._sentinel.approve_step(self):
            return  # anomaly: the update is skipped, grads never applied
        self._ensure_state()
        idx = [i for i, p in enumerate(self._parameter_list)
               if p.grad is not None and p.requires_grad]
        if not idx:
            return
        self._fill_scalars()
        self._apply_update(idx, [_reduced(self._parameter_list[i])
                                 for i in idx])
        self._global_step += 1

    @torch.no_grad()
    def _apply_update(self, idx, grads):
        """Clip, coupled regularizer and update of the parameters at
        positions ``idx`` by ``grads``, in place, with the lr and step the
        device scalars hold. No host sync and no host state changes, so a
        CUDA graph can hold it; the caller fills the scalars and counts
        the step."""
        params = [self._parameter_list[i] for i in idx]
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_raw(params, grads)
        ctxs = self._param_update_ctx(params)
        self._memo = {}
        try:
            for i, p, g, ctx in zip(idx, params, grads, ctxs):
                rc = self._regularized_grad(p, None)
                if rc is not None:
                    g = g + rc * p
                self._update_into(p, g.to(p.dtype), self._state[i], ctx)
        finally:
            self._memo = None

    def _update_into(self, p, g, state, ctx):
        """``_update`` with the device lr and step; what it returns as new
        tensors (a master's cast) is copied into ``p`` and ``state``."""
        new_p, new_state = self._update(p, g, state, self._lr_t,
                                        self._step_t, ctx)
        for k, v in new_state.items():
            if v is not state[k]:
                state[k].copy_(v)
        p.copy_(new_p)

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward and step (the dygraph form; there is no static
        Program in the port)."""
        loss.backward()
        self.step()
        return None, None

    def backward(self, loss, **kw):
        loss.backward()

    def apply_gradients(self, params_grads):
        for p, g in params_grads:
            p.grad = g
        self.step()


class SGD(Optimizer):
    _elementwise_update = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)

    def _update(self, p, g, s, lr, step, ctx=None):
        return p.sub_(lr * g), s


class Momentum(Optimizer):
    _elementwise_update = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(
            p, memory_format=torch.contiguous_format)}

    def _update(self, p, g, s, lr, step, ctx=None):
        v = s["velocity"].mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)
        return p, s


class Adam(Optimizer):
    _elementwise_update = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _init_state(self, p):
        dt = torch.float32 if self._multi_precision else p.dtype
        st = {"moment1": _zeros_as(p, dt), "moment2": _zeros_as(p, dt)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master"] = p.detach().float().clone()
        return st

    def _update(self, p, g, s, lr, step, ctx=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        master = s.get("master")
        work = master if master is not None else p
        gf = g.to(work.dtype)
        m = s["moment1"].mul_(b1).add_((1 - b1) * gf)
        v = s["moment2"].mul_(b2).add_((1 - b2) * gf * gf)
        mhat = m / self._scalar(("bc", b1), lambda: 1 - b1 ** step)
        vhat = v / self._scalar(("bc", b2), lambda: 1 - b2 ** step)
        work.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        if master is not None:
            return work.to(p.dtype), s
        return work, s


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p *= 1 - lr * ratio * coeff``
    before the Adam update (``apply_decay_param_fun(name)`` false gives
    coeff 0; ``lr_ratio(p)`` gives ratio, default 1)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, *,
                 device: DeviceLike = None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, device=device)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        if isinstance(weight_decay, (int, float)):
            self._coeff = float(weight_decay)
        elif isinstance(weight_decay, torch.Tensor):
            self._coeff = float(weight_decay)
        else:
            raise TypeError(
                f"AdamW weight_decay must be a float or Tensor, got "
                f"{type(weight_decay).__name__}")

    def _param_update_ctx(self, params):
        ctxs = []
        for p in params:
            decay = True
            if self._apply_decay_param_fun is not None:
                decay = bool(self._apply_decay_param_fun(
                    self._names[id(p)]))
            ratio = 1.0
            if self._lr_ratio is not None:
                ratio = float(self._lr_ratio(p))
            ctxs.append((self._coeff if decay else 0.0, ratio))
        return ctxs

    def _update(self, p, g, s, lr, step, ctx=None):
        coeff, ratio = ctx
        lr = self._scalar(("lr", ratio), lambda: lr * ratio)
        master = s.get("master")
        work = master if master is not None else p
        work.mul_(self._scalar(("decay", ratio, coeff),
                               lambda: 1.0 - lr * coeff))
        return super()._update(p, g, s, lr, step)


def _reduced(p):
    """``p.grad``, laid out as ``p`` when it is a DTensor parameter (a
    gradient partial over the data axis summed once; ``mesh.reduce_grad``)."""
    g = p.grad
    if type(g) is torch.Tensor or g is None:
        return g
    from ..distributed.mesh import reduce_grad
    return reduce_grad(p, g)


def _zeros(p, fill=0.0):
    return torch.full_like(p, fill, memory_format=torch.contiguous_format)


def _zeros_as(p, dtype):
    """Zeros of ``p``'s shape in ``dtype`` on its device, laid out as
    ``p`` when it is a DTensor (a state on a mesh lives where its
    parameter's shard does)."""
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def _norm32(t):
    """``sqrt(sum(t ** 2))`` in float32, on the device."""
    return t.float().square().sum().sqrt()


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment (reference ``:343``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _update(self, p, g, s, lr, step, ctx=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = s["moment"].mul_(b1).add_((1 - b1) * g)
        u = torch.maximum(s["inf_norm"].mul_(b2), g.abs(),
                          out=s["inf_norm"])
        lrc = self._scalar(("lr_bc", b1), lambda: lr / (1 - b1 ** step))
        p.sub_(lrc * m / (u + eps))
        return p, s


class Adagrad(Optimizer):
    """Per-element lr scaled by the summed squared gradients (reference
    ``:364``)."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": _zeros(p, self._init_acc)}

    def _update(self, p, g, s, lr, step, ctx=None):
        m = s["moment"].add_(g * g)
        p.sub_(lr * g / (m.sqrt() + self._epsilon))
        return p, s


class Adadelta(Optimizer):
    """reference ``:383``. The update reads the old ``avg_sq_update``
    before it moves."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_sq_grad": _zeros(p), "avg_sq_update": _zeros(p)}

    def _update(self, p, g, s, lr, step, ctx=None):
        rho, eps = self._rho, self._epsilon
        ag = s["avg_sq_grad"].mul_(rho).add_((1 - rho) * g * g)
        au = s["avg_sq_update"]
        upd = g * torch.sqrt(au + eps) / torch.sqrt(ag + eps)
        au.mul_(rho).add_((1 - rho) * upd * upd)
        p.sub_(lr * upd)
        return p, s


class RMSProp(Optimizer):
    """reference ``:403``, plain and ``centered``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros(p), "momentum": _zeros(p)}
        if self._centered:
            st["mean_grad"] = _zeros(p)
        return st

    def _update(self, p, g, s, lr, step, ctx=None):
        rho, eps = self._rho, self._epsilon
        ms = s["mean_square"].mul_(rho).add_((1 - rho) * g * g)
        if self._centered:
            mg = s["mean_grad"].mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = s["momentum"].mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)
        return p, s


class Lamb(Optimizer):
    """Layer-wise adaptive Adam (reference ``:436``): the Adam direction
    plus ``lamb_weight_decay * p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0), both norms in float32 on
    the device. ``exclude_from_weight_decay_fn`` is not taken: the
    reference stores it and never reads it."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None, name=None,
                 *, device: DeviceLike = None):
        if exclude_from_weight_decay_fn is not None:
            raise NotImplementedError(
                "Lamb: exclude_from_weight_decay_fn is not taken; the "
                "reference stores it and never reads it, so every "
                "parameter is decayed by lamb_weight_decay")
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device=device)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _update(self, p, g, s, lr, step, ctx=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = s["moment1"].mul_(b1).add_((1 - b1) * g)
        v = s["moment2"].mul_(b2).add_((1 - b2) * g * g)
        mhat = m / self._scalar(("bc", b1), lambda: 1 - b1 ** step)
        vhat = v / self._scalar(("bc", b2), lambda: 1 - b2 ** step)
        r = mhat / (torch.sqrt(vhat) + eps) + self._lamb_wd * p
        w_norm, r_norm = _norm32(p), _norm32(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        p.sub_((lr * trust).to(p.dtype) * r)
        return p, s


class LarsMomentum(Optimizer):
    """Momentum with a layer-wise local lr (reference ``:464``):
    ``lr * lars_coeff * |p| / (|g| + lars_weight_decay * |p|)``, ``lr``
    where either norm is 0; both norms in float32 on the device, taken
    before the velocity moves."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device=device)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _update(self, p, g, s, lr, step, ctx=None):
        w_norm, g_norm = _norm32(p), _norm32(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm / (g_norm
                                              + self._lars_wd * w_norm),
            lr)
        v = s["velocity"].mul_(self._momentum).add_(
            local_lr.to(p.dtype) * (g + self._lars_wd * p))
        p.sub_(v)
        return p, s


class Ftrl(Optimizer):
    """Follow-the-regularized-leader (reference ``:490``). ``sigma``
    reads the old ``squared``, ``linear`` the old parameter."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, *, device: DeviceLike = None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _init_state(self, p):
        return {"squared": _zeros(p), "linear": _zeros(p)}

    def _update(self, p, g, s, lr, step, ctx=None):
        lp = self._lr_power
        sq = s["squared"]
        new_sq = sq + g * g
        sigma = (torch.pow(new_sq, -lp) - torch.pow(sq + 1e-30, -lp)) / lr
        lin = s["linear"].add_(g).sub_(sigma * p)
        sq.copy_(new_sq)
        quad = torch.pow(new_sq, -lp) / lr + 2 * self._l2
        p.copy_((lin.clamp(-self._l1, self._l1) - lin) / quad)
        return p, s


class ExponentialMovingAverage:
    """EMA of the trainable parameters (reference ``:519-611``):
    ``ema = decay * ema + (1 - decay) * p`` after each ``update()``, with
    the ``thres_steps`` ramp ``min(decay, (1 + n) / (10 + n))``, and the
    shadows bias-corrected by ``1 - prod(decays)`` on :meth:`apply`.

    The reference swaps the parameters' arrays on ``apply``/``restore``.
    Here a parameter never moves, since every captured program reads it
    where it is: ``apply`` copies the parameters into backups the EMA
    keeps and the corrected shadows into the parameters, in place, and
    :meth:`restore` copies the backups back. The update is one
    multi-tensor pass over every shadow (``torch._foreach_*``), as the
    reference fuses it into one program. Pass ``parameters=`` here or
    to the first ``update()``; a ``(name, parameter)`` pair is taken as
    the optimizers take it."""

    def __init__(self, decay=0.999, thres_steps=None, name=None,
                 parameters=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._step = 0
        self._decay_pow = 1.0
        self._params, self._shadows, self._backups = [], [], []
        self._ids = set()
        self._applied = False
        if parameters is not None:
            self._register(parameters)

    def _register(self, params):
        for item in params:
            p = item[1] if isinstance(item, tuple) else item
            if id(p) not in self._ids and p.requires_grad:
                self._ids.add(id(p))
                self._params.append(p)
                self._shadows.append(torch.zeros_like(p,
                                                      requires_grad=False))

    @torch.no_grad()
    def update(self, parameters=None):
        """One EMA step over the registered (or given) parameters."""
        if parameters is not None:
            self._register(parameters)
        elif not self._params:
            raise ValueError(
                "no parameters registered; pass parameters= to the "
                "constructor or to the first update()")
        self._step += 1
        d = self._decay
        if self._thres_steps is not None:
            d = min(d, (1.0 + self._step) / (10.0 + self._step))
        self._decay_pow *= d
        # the reference's float32 d and 1 - d
        d32 = np.float32(d)
        torch._foreach_mul_(self._shadows, float(d32))
        torch._foreach_add_(self._shadows, torch._foreach_mul(
            self._params, float(np.float32(1.0) - d32)))

    def apply(self, parameters=None, need_restore=True):
        """Context manager: the parameters hold their bias-corrected EMA
        values inside the block (restored after unless
        ``need_restore=False``). Raises before any ``update()``."""
        if parameters is not None:
            self._register(parameters)

        @contextlib.contextmanager
        def ctx():
            if self._step == 0:
                raise RuntimeError(
                    "ExponentialMovingAverage.apply() before any update(): "
                    "the shadow values are still zero-initialized")
            corr = 1.0 - self._decay_pow
            with torch.no_grad():
                while len(self._backups) < len(self._params):
                    self._backups.append(torch.empty_like(
                        self._params[len(self._backups)],
                        requires_grad=False))
                torch._foreach_copy_(self._backups, self._params)
                torch._foreach_copy_(self._params, self._shadows)
                if corr > 0:
                    torch._foreach_div_(self._params, corr)
            self._applied = True
            try:
                yield self
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    @torch.no_grad()
    def restore(self, parameters=None):
        """Copy the values from before :meth:`apply` back into the
        parameters (nothing when none is applied)."""
        if self._applied:
            torch._foreach_copy_(self._params, self._backups)
            self._applied = False
