"""``ExponentialMovingAverage``, ``incubate.optimizer.LookAhead`` and
``ModelAverage`` of the port against the JAX package's: the same NumPy
parameters and gradients, the same steps, values at 1e-5. The port never
moves a parameter (every captured program reads it in place), so each
test also holds every parameter's ``data_ptr`` across the steps,
``apply`` and ``restore``, and the values after ``restore`` bit-equal to
those before ``apply``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.core.tensor import Parameter as JParameter  # noqa: E402
from paddle_tpu.core.tensor import stable_uid  # noqa: E402
from paddle_tpu.incubate.optimizer import LookAhead as JLookAhead  # noqa
from paddle_tpu.incubate.optimizer import ModelAverage as JModelAverage  # noqa
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.incubate.optimizer import (LookAhead,  # noqa: E402
                                                 ModelAverage)

SHAPES = [(4, 3), (3,), (2, 2, 2)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(v)) for v in vals]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    return jps, tps


def _ptrs(tps):
    return [p.data_ptr() for p in tps]


def _close(jps, tps):
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)


def _sgd_step(rng, jo, to, jps, tps):
    grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    for jp, tp, g in zip(jps, tps, grads):
        jp._grad = jnp.asarray(g)
        tp.grad = torch.from_numpy(g)
    jo.step()
    to.step()


@pytest.mark.parametrize("thres_steps", [None, 100])
def test_ema_matches_jax(thres_steps):
    jps, tps = _pair()
    ptrs = _ptrs(tps)
    jo = jopt.SGD(0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps, device="cpu")
    jema = jopt.ExponentialMovingAverage(0.9, thres_steps=thres_steps,
                                         parameters=jps)
    tema = topt.ExponentialMovingAverage(0.9, thres_steps=thres_steps,
                                         parameters=tps)
    rng = np.random.default_rng(1)
    for _ in range(6):
        _sgd_step(rng, jo, to, jps, tps)
        jema.update()
        tema.update()
    for je, te in zip(jema._shadow.values(), tema._shadows):
        np.testing.assert_allclose(te.numpy(), np.asarray(je[1]), **TOL)
    before = [p.detach().clone() for p in tps]
    with jema.apply(), tema.apply():
        _close(jps, tps)
        assert _ptrs(tps) == ptrs
    for b, p in zip(before, tps):
        assert torch.equal(b, p.detach())
    _close(jps, tps)
    # need_restore=False leaves the averages in until restore()
    with tema.apply(need_restore=False):
        pass
    assert not torch.equal(before[0], tps[0].detach())
    tema.restore()
    assert torch.equal(before[0], tps[0].detach())
    assert _ptrs(tps) == ptrs


def test_ema_apply_before_update_raises_and_late_registration():
    _, tps = _pair()
    ema = topt.ExponentialMovingAverage(0.5)
    with pytest.raises(ValueError, match="no parameters"):
        ema.update()
    with pytest.raises(RuntimeError, match="before any update"):
        with ema.apply(parameters=tps):
            pass
    ema.update()
    frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
    ema.update(parameters=[frozen])
    assert len(ema._params) == 3        # frozen parameters are not tracked


def test_lookahead_matches_jax():
    jps, tps = _pair(2)
    ptrs = _ptrs(tps)
    jla = JLookAhead(jopt.Momentum(0.05, 0.9, parameters=jps), alpha=0.5,
                     k=3)
    tla = LookAhead(topt.Momentum(0.05, 0.9, parameters=tps, device="cpu"),
                    alpha=0.5, k=3)
    rng = np.random.default_rng(3)
    for i in range(8):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        for jp, tp, g in zip(jps, tps, grads):
            jp._grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g)
        jla.step()
        tla.step()
        _close(jps, tps)
    assert _ptrs(tps) == ptrs
    for jp, slow in zip(jps, tla._slow):
        np.testing.assert_allclose(slow.numpy(),
                                   np.asarray(jla._slow[stable_uid(jp)]),
                                   **TOL)


def test_lookahead_refuses_bad_arguments():
    _, tps = _pair()
    inner = topt.SGD(0.1, parameters=tps, device="cpu")
    with pytest.raises(ValueError):
        LookAhead(inner, alpha=1.5)
    with pytest.raises(ValueError):
        LookAhead(inner, k=0)


@pytest.mark.parametrize("windows", [(2, 4, 0.5), (3, 3, 1.0), (1, 2, 0.3)])
def test_model_average_matches_jax(windows):
    lo, hi, rate = windows
    jps, tps = _pair(4)
    ptrs = _ptrs(tps)
    jo = jopt.SGD(0.1, parameters=jps)
    to = topt.SGD(0.1, parameters=tps, device="cpu")
    jma = JModelAverage(rate, parameters=jps, min_average_window=lo,
                        max_average_window=hi)
    tma = ModelAverage(rate, parameters=tps, min_average_window=lo,
                       max_average_window=hi)
    rng = np.random.default_rng(5)
    for i in range(9):
        _sgd_step(rng, jo, to, jps, tps)
        jma.step()
        tma.step()
        before = [p.detach().clone() for p in tps]
        with jma.apply(), tma.apply():
            _close(jps, tps)
            assert _ptrs(tps) == ptrs
        for b, p in zip(before, tps):
            assert torch.equal(b, p.detach())
        _close(jps, tps)
    assert (tma._n_new, tma._n_old) == (
        next(iter(jma._new.values()))[1],
        next(iter(jma._old.values()))[1] if jma._old else 0)
