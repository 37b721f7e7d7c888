"""Fleet utilities: activation recompute and gradient merge (counterpart
of ``paddle_tpu/distributed/fleet/utils.py``).

``recompute(function, *args, **kwargs)`` runs ``function`` without
keeping its activations and runs it again in the backward to rebuild
them (``torch.utils.checkpoint``, non-reentrant). The re-run must see
the forward's random masks. The JAX package gets them by construction:
its dropout keys are inputs of the traced block, so
``jax.checkpoint`` re-runs it under the same keys. The port's dropout
draws from its own generators (``core/generator.py``), not torch's
default one that ``torch.utils.checkpoint`` would restore, and a compiled
train step runs its backward inside a CUDA-graph capture, where what a
generator's state calls do is torch's choice (torch 2.11:
``graphsafe_get_state`` hands back the live state, not a snapshot, and
``clone_state`` is refused). So the forward keeps the block's draws
(``generator.keeping_draws``: the bool masks, which plain autograd keeps
for the backward as well) and the re-run reuses them
(``generator.reusing_draws``) and draws nothing: gradients with
recompute equal those without, bit for bit, in both lanes, and the
generator advances exactly as it would without recompute. The re-run also
runs under the AMP state of the forward (``amp._STATE``, process-wide).

The JAX package passes an eager call straight through and checkpoints
only under a trace; the port checkpoints in both, so that the graphed
and the eager lane of a train step run the same code. A ``recompute``
inside another one's function runs its function directly: the outer one
already drops the activations.

``GradientMergeOptimizer`` is host code and ported as is;
``LocalSGDOptimizer`` averages the parameters over the data-parallel
ranks every ``k_steps`` with the port's collectives.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp
from ...core import generator

__all__ = ["recompute", "GradientMergeOptimizer", "LocalSGDOptimizer"]

#: depth of recompute functions running in this thread (the forward and
#: the re-run each count)
_LOCAL = threading.local()


@contextlib.contextmanager
def _inside():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


@contextlib.contextmanager
def _amp_state(state):
    prev = dict(amp._STATE)
    amp._STATE.update(state)
    try:
        yield
    finally:
        amp._STATE.update(prev)


def recompute(function: Callable, *args, **kwargs):
    """reference: fleet/utils/recompute.py:63. ``use_reentrant`` and
    ``preserve_rng_state`` are accepted and popped: the checkpoint is
    always non-reentrant, and the re-run always sees the forward's random
    masks (they are kept, not re-drawn)."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    if getattr(_LOCAL, "depth", 0):
        return function(*args, **kwargs)
    draws = []
    forward_amp = dict(amp._STATE)
    runs = [0]

    def run(*a, **k):
        runs[0] += 1
        if runs[0] == 1:
            ctx = generator.keeping_draws(draws)
        else:
            ctx = contextlib.ExitStack()
            ctx.enter_context(generator.reusing_draws(draws))
            ctx.enter_context(_amp_state(forward_amp))
        with _inside(), ctx:
            return function(*a, **k)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


class GradientMergeOptimizer:
    """reference: fluid/optimizer.py:5949. Accumulate ``k_steps`` steps
    of gradients, then apply their sum (``avg=False``) or mean once."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self._k = int(k_steps)
        self._avg = bool(avg)
        self._acc = {}
        self._count = 0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    @torch.no_grad()
    def step(self):
        inner = self._inner
        self._count += 1
        for p in inner._parameter_list:
            if p.grad is None:
                continue
            if id(p) in self._acc:
                self._acc[id(p)] = self._acc[id(p)] + p.grad
            else:
                self._acc[id(p)] = p.grad
        if self._count < self._k:
            for p in inner._parameter_list:
                p.grad = None
            return
        for p in inner._parameter_list:
            g = self._acc.pop(id(p), None)
            if g is None:
                continue
            p.grad = g / self._k if self._avg else g
        inner.step()
        self._count = 0
        self._acc = {}

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()


class LocalSGDOptimizer:
    """reference: distributed/fleet/meta_optimizers/localsgd_optimizer.py
    :25: ``k_steps`` local optimizer steps between parameter averages
    across the data-parallel ranks, from ``begin_step`` on. Each rank
    trains its own replica on its own batches (plain parameters, not a
    ``DataParallel`` model, whose gradients are reduced every step); the
    average is an all-reduce (AVG) of every parameter over the ``dp``
    group of the hybrid topology, or the whole world without one."""

    def __init__(self, inner_optimizer, k_steps=1, begin_step=1):
        self._inner = inner_optimizer
        self._k = max(1, int(k_steps))
        self._begin = max(1, int(begin_step))
        self._t = 0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    @torch.no_grad()
    def _average_params(self):
        from .. import collective as C
        from ..topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        group = hcg.get_data_parallel_group() if hcg is not None else None
        for p in self._inner._parameter_list:
            C.all_reduce(p.detach(), op=C.ReduceOp.AVG, group=group)

    def step(self):
        self._inner.step()
        self._t += 1
        if self._t >= self._begin and (self._t - self._begin) % self._k == 0:
            self._average_params()

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
