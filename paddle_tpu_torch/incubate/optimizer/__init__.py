"""paddle.incubate.optimizer: ``LookAhead`` and ``ModelAverage``
(counterpart of ``paddle_tpu/incubate/optimizer/__init__.py:17-141``).

Both wrap plain Python around the parameters, as the reference does.
The reference rebinds each parameter's array to the slow or averaged
copy; here a parameter never moves, since every captured program
(``Model``'s train and eval steps) reads it where it is, so those copies
are written into the parameters in place (``copy_``) and the values they
replace are kept in tensors the wrapper owns. A wrapper takes the
parameters as tensors or as ``(name, parameter)`` pairs, as the
optimizers do."""
from __future__ import annotations

import torch

__all__ = ["LookAhead", "ModelAverage"]


def _tensors(params):
    return [item[1] if isinstance(item, tuple) else item
            for item in (params or [])]


class LookAhead:
    """Every ``k`` steps of the inner optimizer, ``slow += alpha * (fast -
    slow)`` and the parameters take the slow values (arXiv:1907.08610;
    reference ``:17-67``). The slow copies start from the parameters
    before the first inner step. :meth:`step` is the inner step and the
    sync; under ``Model.train_batch``, which runs the inner optimizer
    inside its compiled step, call :meth:`_track` before training and
    :meth:`_after_inner_step` after each step."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if k < 1:
            raise ValueError(f"k must be a positive integer, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._step_num = 0
        self._slow = None

    def _params(self):
        return [p for p in self.inner_optimizer._parameter_list
                if p.requires_grad]

    @torch.no_grad()
    def _track(self):
        """Copy the parameters into the slow weights, once."""
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params()]

    @torch.no_grad()
    def _after_inner_step(self):
        """Count one inner step; on every ``k``-th move the slow weights
        toward the parameters and copy them in."""
        self._step_num += 1
        if self._step_num % self.k == 0:
            for p, slow in zip(self._params(), self._slow):
                slow.add_(self.alpha * (p - slow))
                p.copy_(slow)

    def step(self):
        self._track()
        self.inner_optimizer.step()
        self._after_inner_step()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()


class ModelAverage:
    """A windowed running average of the parameters, copied into them by
    :meth:`apply` and back by :meth:`restore` (reference ``:69-141``):
    :meth:`step` (after the optimizer's) adds the parameters to the recent
    sum; once it holds at least ``min_average_window`` steps and at least
    ``min(max_average_window, max(1, int(updates * average_window_rate)))``
    it rotates into the history, which is dropped first once it holds
    ``max_average_window`` steps. The average is ``(recent + history) /
    (its steps)``."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.avg_window_rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._params = _tensors(parameters)
        self._new = self._old = self._backup = None
        self._n_new = self._n_old = 0
        self._updates = 0
        self._applied = False

    @torch.no_grad()
    def step(self):
        """Add the parameters to the recent window and rotate it per the
        reference's rule."""
        if self._new is None:
            self._new = [torch.zeros_like(p, requires_grad=False)
                         for p in self._params]
            self._old = [torch.zeros_like(p, requires_grad=False)
                         for p in self._params]
        self._updates += 1
        torch._foreach_add_(self._new, self._params)
        self._n_new += 1
        thresh = min(self.max_window,
                     max(1, int(self._updates * self.avg_window_rate)))
        if self._n_new >= self.min_window and self._n_new >= thresh:
            if self._n_old >= self.max_window:
                torch._foreach_zero_(self._old)     # drop stale history
                self._n_old = 0
            torch._foreach_add_(self._old, self._new)
            self._n_old += self._n_new
            torch._foreach_zero_(self._new)
            self._n_new = 0

    def apply(self, executor=None, need_restore=True):
        """Copy the averages into the parameters now (the values they
        held are kept); as a context manager, :meth:`restore` on exit
        unless ``need_restore=False``."""
        n = self._n_new + self._n_old
        with torch.no_grad():
            if self._backup is None:
                self._backup = [torch.empty_like(p, requires_grad=False)
                                for p in self._params]
            torch._foreach_copy_(self._backup, self._params)
            self._applied = True
            if n > 0:
                for p, s, so in zip(self._params, self._new, self._old):
                    p.copy_(s).add_(so).div_(n)
        ma = self

        class _Ctx:
            def __enter__(self):
                return ma

            def __exit__(self, *a):
                if need_restore:
                    ma.restore()
                return False
        return _Ctx()

    @torch.no_grad()
    def restore(self, executor=None):
        if self._applied:
            torch._foreach_copy_(self._params, self._backup)
            self._applied = False
