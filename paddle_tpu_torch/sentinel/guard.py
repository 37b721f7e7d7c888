"""On-device step health probe: one fused reduction, one 8-byte fetch
(counterpart of ``paddle_tpu/sentinel/guard.py``).

``FLAGS_check_nan_inf`` checks every output from the host, one device
round trip a tensor. The probe instead reduces the loss and every
gradient to one finiteness flag on the device and fetches a length-2
float32 vector ``[finite, loss]``: the sentinel's one host sync a
guarded step, counted in ``sentinel.host_syncs``.

The JAX package jits the reduction (``_fused_health``). Here it is a
:class:`~paddle_tpu_torch.core.graphs.Program`, one per set of gradient
shapes and types: on CUDA its first call captures the reduction (each
gradient's ``aminmax``, which a NaN or an infinity reaches, and the
loss's ``isfinite``) into a CUDA graph and every later call replays it,
reading the first call's gradient tensors in place (a gradient that is
another tensor is copied into them first). A loss given as a Python
float is written into a device scalar by a fill, never a copy from the
host. On the CPU the same function runs eagerly.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from ..core import monitor as _monitor
from ..core.graphs import GraphPool, Program

#: probe programs kept per guard (one a gradient signature)
_PROBES_MAX = 4


def _fused_health(params, holder, *inputs):
    """All-finite flag over the loss (last input) and every gradient,
    packed with the loss into one float32 ``[finite, loss]``."""
    *grads, loss = inputs
    checks = []
    for g in grads:
        if g.numel():
            lo, hi = torch.aminmax(g.reshape(-1))
            checks += [lo, hi]
    flags = torch.isfinite(torch.stack([c.float() for c in checks])).all() \
        if checks else torch.ones((), dtype=torch.bool, device=loss.device)
    finite = flags & torch.isfinite(loss)
    return torch.stack([finite.float(), loss.float().reshape(())])


def poison_grads(optimizer):
    """Fill every present gradient with NaN, in place (the FaultInjector
    ``nan`` action at the ``grads`` site): a captured probe reads the
    gradients where they are."""
    with torch.no_grad():
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad.fill_(math.nan)


def poison_loss(loss):
    """NaN of the shape and type of ``loss`` (the ``nan`` action at the
    ``loss`` site): a tensor for a tensor, else a float."""
    loss = getattr(loss, "_data", loss)
    if isinstance(loss, torch.Tensor):
        return torch.full_like(loss, math.nan)
    return math.nan


class _Holder:
    """The state a probe program binds to: its graph pool."""

    def __init__(self, device):
        self.graph_pool = GraphPool(device)


class StepGuard:
    """Amortized on-device health probe over (loss, grads).

    ``probe`` runs the reduction and fetches its two floats: ONE host
    sync, counted in ``sentinel.host_syncs``. ``should_check`` implements
    every-N-steps amortization: unchecked steps cost nothing.
    """

    def __init__(self, check_every: int = 1):
        if int(check_every) < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.check_every = int(check_every)
        self._probes: "OrderedDict[tuple, Program]" = OrderedDict()
        self._holders = {}
        self._loss_bufs = {}

    def should_check(self, step: int) -> bool:
        return step % self.check_every == 0

    def _program(self, key) -> Program:
        prog = self._probes.get(key)
        if prog is None:
            if len(self._probes) >= _PROBES_MAX:
                _, old = self._probes.popitem(last=False)
                old.release()
            prog = self._probes[key] = Program(_fused_health,
                                               name="sentinel_probe")
        else:
            self._probes.move_to_end(key)
        return prog

    def _loss_tensor(self, loss, device) -> torch.Tensor:
        """The loss as a float32 device scalar: a tensor as it is, a
        number filled into this guard's scalar for ``device``."""
        if isinstance(loss, torch.Tensor):
            # the tensor itself where it can be, so a replay copies nothing
            loss = loss.detach() if loss.requires_grad else loss
            return loss.reshape(()) if loss.dim() else loss
        buf = self._loss_bufs.get(device)
        if buf is None:
            buf = self._loss_bufs[device] = torch.zeros(
                (), dtype=torch.float32, device=device)
        buf.fill_(0.0 if loss is None else float(loss))
        return buf

    def probe(self, grads: Sequence, loss=None,
              device=None) -> Tuple[bool, Optional[float]]:
        """Returns ``(finite, loss_value)``; ``loss_value`` is None when no
        loss was supplied (the probe then covers gradients only)."""
        grads = [getattr(g, "_data", g) for g in grads]
        loss = getattr(loss, "_data", loss)
        have_loss = loss is not None
        if device is None:
            device = grads[0].device if grads else (
                loss.device if isinstance(loss, torch.Tensor)
                else torch.device("cpu"))
        device = torch.device(device)
        loss_t = self._loss_tensor(loss, device)
        key = (device, tuple((tuple(g.shape), g.dtype) for g in grads),
               loss_t.dtype)
        holder = self._holders.get(device)
        if holder is None:
            holder = self._holders[device] = _Holder(device)
        with torch.no_grad():
            out = self._program(key)([], holder, *grads, loss_t)
        _monitor.stat_add("sentinel.checks", 1)
        _monitor.stat_add("sentinel.host_syncs", 1)
        finite, value = out.tolist()    # the one fetch: 8 bytes
        return bool(finite), value if have_loss else None
