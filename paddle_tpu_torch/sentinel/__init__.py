"""Numerical-anomaly sentinel: NaN/Inf guard, divergence detection and
rollback to last-known-good checkpoints (counterpart of
``paddle_tpu/sentinel/__init__.py``).

Three layers, each usable alone:

- :class:`StepGuard` / :class:`LossSpikeDetector`: detection. One
  on-device finiteness reduction over the loss and every gradient (a
  captured program on CUDA) with one 8-byte fetch a guarded step, and a
  host EWMA z-score spike detector over the loss the trainer fetched.
- :class:`PolicyEngine` / :class:`Sentinel`: response. The escalation
  ladder (``skip_step`` → ``quarantine_batch`` → ``rollback`` → ``halt``)
  driven by consecutive anomaly counts, hooked into ``Optimizer.step`` so
  a poisoned update never reaches the parameters.
- :class:`CheckpointRollback`: recovery. Health-stamped sharded
  snapshots with a newest-healthy restore walk, copied in place.

Quickstart::

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import sentinel

    rb = sentinel.CheckpointRollback("ckpts", model=net, optimizer=opt)
    guard = sentinel.Sentinel(
        sentinel.SentinelConfig(quarantine_dir="quarantine"),
        optimizer=opt, rollback=rb)
    for step, (x, y) in enumerate(loader):
        loss = loss_fn(net(x), y)
        loss.backward()
        guard.observe(loss=loss, batch=([x], [y]))
        opt.step()               # guarded
        opt.clear_grad()
        if step % 50 == 0:
            rb.snapshot(step)

``Model.prepare`` takes a guarded optimizer, and
``hapi.callbacks.AnomalyGuardCallback`` wires all of this into ``fit``.
"""
from ..distributed.elastic import DIVERGENCE_EXIT_CODE  # noqa: F401
from .detector import LossSpikeDetector  # noqa: F401
from .guard import StepGuard, poison_grads, poison_loss  # noqa: F401
from .policy import (  # noqa: F401
    ACTIONS, DEFAULT_LADDER, AnomalyReport, PolicyEngine, Sentinel,
    SentinelConfig)
from .quarantine import quarantine_batch, read_quarantine  # noqa: F401
from .rollback import CheckpointRollback  # noqa: F401

__all__ = [
    "ACTIONS",
    "DEFAULT_LADDER",
    "DIVERGENCE_EXIT_CODE",
    "AnomalyReport",
    "CheckpointRollback",
    "LossSpikeDetector",
    "PolicyEngine",
    "Sentinel",
    "SentinelConfig",
    "StepGuard",
    "poison_grads",
    "poison_loss",
    "quarantine_batch",
    "read_quarantine",
]
