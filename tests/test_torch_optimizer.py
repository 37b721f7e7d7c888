"""The port's optimizers, clips, regularizers and LR schedulers against the
JAX package's: the same NumPy parameters and gradients through both, one
step and ten, and the optimizer state carried between the packages
through a ``.pdopt`` file."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import framework_io as jio  # noqa: E402
from paddle_tpu.nn import clip as jclip  # noqa: E402
from paddle_tpu import regularizer as jreg  # noqa: E402
from paddle_tpu.core.tensor import Parameter as JParameter  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io as tio  # noqa: E402
from paddle_tpu_torch.nn import clip as tclip  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import regularizer as treg  # noqa: E402

SHAPES = [(6, 5), (5,), (3, 4, 2)]
NAMES = ["w", "b", "t"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _params(values, regs=None, need_clip=None):
    """Parameters of both packages from the same arrays, named as NAMES,
    with the given per-parameter regularizers and need_clip flags."""
    regs = regs or [None] * len(values)
    need_clip = need_clip or [True] * len(values)
    jps, tps = [], []
    for v, n, r, c in zip(values, NAMES, regs, need_clip):
        jp = JParameter(jnp.asarray(v), name=n)
        tp = torch.nn.Parameter(torch.from_numpy(v.copy()))
        if r is not None:
            jp.regularizer = getattr(jreg, r[0])(r[1])
            tp.regularizer = getattr(treg, r[0])(r[1])
        jp.need_clip = tp.need_clip = c
        jps.append(jp)
        tps.append(tp)
    return jps, tps


def _clip(pkg, spec):
    if spec is None:
        return None
    name, arg = spec
    return getattr(pkg, name)(arg)


# name -> (optimizer class name, kwargs, per-param regularizers, clip)
CONFIGS = {
    "sgd": ("SGD", dict(learning_rate=0.1), None, None),
    "sgd_l2_float_clip_value": ("SGD", dict(learning_rate=0.1,
                                            weight_decay=0.01), None,
                                ("ClipGradByValue", 0.5)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9), None,
                 None),
    "momentum_nesterov_l2_clip_norm": (
        "Momentum", dict(learning_rate=0.05, momentum=0.8,
                         use_nesterov=True), "L2", ("ClipGradByNorm", 1.0)),
    "adam": ("Adam", dict(learning_rate=1e-2), None, None),
    "adam_l1_param_clip_global": ("Adam", dict(learning_rate=1e-2), "L1",
                                  ("ClipGradByGlobalNorm", 1.0)),
    "adamw": ("AdamW", dict(learning_rate=1e-2, weight_decay=0.01), None,
              None),
    "adamw_ratio_decay_fun_clip_global": (
        "AdamW", dict(learning_rate=1e-2, weight_decay=0.05,
                      lr_ratio=lambda p: 0.5 if len(p.shape) == 1 else 1.0,
                      apply_decay_param_fun=lambda n: n != "b"),
        "L2", ("ClipGradByGlobalNorm", 0.7)),
}


def _regs(kind):
    """Per-parameter regularizers: the first parameter gets one."""
    if kind is None:
        return None
    return [(f"{kind}Decay", 0.05), None, None]


def _run(config, steps, seed=0, need_clip=None, sched=False):
    cls, kw, reg, clip = CONFIGS[config]
    jps, tps = _params(_arrays(seed), _regs(reg), need_clip)
    jkw, tkw = dict(kw), dict(kw)
    if sched:
        jkw["learning_rate"] = jopt.lr.LinearWarmup(
            jopt.lr.CosineAnnealingDecay(kw["learning_rate"], 8), 3,
            kw["learning_rate"] / 10, kw["learning_rate"])
        tkw["learning_rate"] = topt.lr.LinearWarmup(
            topt.lr.CosineAnnealingDecay(kw["learning_rate"], 8), 3,
            kw["learning_rate"] / 10, kw["learning_rate"])
    jo = getattr(jopt, cls)(parameters=jps, grad_clip=_clip(jclip, clip),
                            **jkw)
    # the port names parameters by (name, parameter) pairs
    to = getattr(topt, cls)(parameters=list(zip(NAMES, tps)),
                            grad_clip=_clip(tclip, clip), device="cpu", **tkw)
    rng = np.random.default_rng(100 + seed)
    for _ in range(steps):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        for jp, tp, g in zip(jps, tps, grads):
            jp._grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g)
        jo.step()
        to.step()
        if sched:
            jkw["learning_rate"].step()
            tkw["learning_rate"].step()
    return jps, tps, jo, to


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_optimizer_matches_jax(config, steps):
    jps, tps, jo, to = _run(config, steps)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)
    assert to._global_step == jo._global_step == steps


def test_need_clip_false_and_lr_schedule_match_jax():
    jps, tps, _, _ = _run("adamw_ratio_decay_fun_clip_global", 10,
                          need_clip=[True, False, True], sched=True)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)


def test_l1_decay_is_coupled_coeff_times_p_as_in_jax():
    """L1Decay adds coeff * p to the gradient, as L2Decay does (the JAX
    package's behaviour, not sign(p))."""
    v = _arrays(1)
    g = [np.full(s, 0.5, np.float32) for s in SHAPES]
    out = {}
    for kind in ("L1", "L2"):
        _, tps = _params(v, _regs(kind))
        opt = topt.SGD(learning_rate=0.1, parameters=tps, device="cpu")
        for tp, gg in zip(tps, g):
            tp.grad = torch.from_numpy(gg)
        opt.step()
        out[kind] = tps[0].detach().numpy()
    expect = v[0] - 0.1 * (g[0] + 0.05 * v[0])
    np.testing.assert_allclose(out["L1"], expect, **TOL)
    np.testing.assert_array_equal(out["L1"], out["L2"])


def test_lr_schedules_match_jax():
    pairs = [
        (jopt.lr.LinearWarmup(jopt.lr.CosineAnnealingDecay(0.1, 20), 5,
                              0.0, 0.1),
         topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(0.1, 20), 5,
                              0.0, 0.1)),
        (jopt.lr.PolynomialDecay(0.1, 10, cycle=True),
         topt.lr.PolynomialDecay(0.1, 10, cycle=True)),
        (jopt.lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
         topt.lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01])),
        (jopt.lr.NoamDecay(64, 4), topt.lr.NoamDecay(64, 4)),
    ]
    for js, ts in pairs:
        for _ in range(25):
            assert ts() == js()
            js.step()
            ts.step()
        assert ts.state_dict() == js.state_dict()
    jr = jopt.lr.ReduceOnPlateau(0.1, patience=1)
    tr = topt.lr.ReduceOnPlateau(0.1, patience=1)
    for m in (1.0, 1.0, 1.0, 0.5, 0.5, 0.5):
        jr.step(m)
        tr.step(torch.tensor(m))
        assert tr() == jr()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_state_dict_round_trip_through_pdopt(tmp_path, direction):
    kw = dict(learning_rate=None, weight_decay=0.01)
    values = _arrays(3)
    jps, tps = _params(values)

    def sched(pkg):
        return pkg.lr.LinearWarmup(pkg.lr.CosineAnnealingDecay(1e-2, 8), 2,
                                   1e-3, 1e-2)
    js, ts = sched(jopt), sched(topt)
    jo = jopt.AdamW(parameters=jps, **dict(kw, learning_rate=js))
    to = topt.AdamW(parameters=tps, device="cpu", **dict(kw, learning_rate=ts))
    rng = np.random.default_rng(8)

    def step(opts, ps_list):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        for opt, ps in zip(opts, ps_list):
            for p, g in zip(ps, grads):
                if isinstance(p, torch.Tensor):
                    p.grad = torch.from_numpy(g)
                else:
                    p._grad = jnp.asarray(g)
            opt.step()
            opt._learning_rate.step()

    path = str(tmp_path / "opt.pdopt")
    if direction == "port_to_jax":
        for _ in range(3):
            step([to], [tps])
        tio.save(to.state_dict(), path)
        for jp, tp in zip(jps, tps):
            jp._data = jnp.asarray(tp.detach().numpy())
        jo.set_state_dict(jio.load(path))
        assert jo._global_step == 3 and js.last_epoch == ts.last_epoch
    else:
        for _ in range(3):
            step([jo], [jps])
        jio.save(jo.state_dict(), path)
        with torch.no_grad():
            for jp, tp in zip(jps, tps):
                tp.copy_(torch.from_numpy(np.array(jp._data)))
        to.set_state_dict(tio.load(path))
        assert to._global_step == 3 and js.last_epoch == ts.last_epoch
    assert sorted(to.state_dict()) == sorted(jo.state_dict())
    for _ in range(2):
        step([jo, to], [jps, tps])
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)


def test_clip_functional_forms_match_jax():
    values = _arrays(4)
    grads = [g * 3 for g in _arrays(5)]
    jps, tps = _params(values, need_clip=[True, True, False])
    for name, arg in (("ClipGradByValue", 0.4), ("ClipGradByNorm", 1.5),
                      ("ClipGradByGlobalNorm", 2.0),
                      ("GradientClipByGlobalNorm", 2.0)):
        jout = getattr(jclip, name)(arg)(
            list(zip(jps, [jnp.asarray(g) for g in grads])))
        tout = getattr(tclip, name)(arg)(
            list(zip(tps, [torch.from_numpy(g) for g in grads])))
        for (_, jg), (tp, tg) in zip(jout, tout):
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg._data),
                                       **TOL)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    values, grads = _arrays(6), [g * 4 for g in _arrays(7)]
    jps, tps = _params(values)
    for jp, tp, g in zip(jps, tps, grads):
        jp._grad = jnp.asarray(g)
        tp.grad = torch.from_numpy(g.copy())
    jt = jclip.clip_grad_norm_(jps, 1.0, norm_type)
    tt = tclip.clip_grad_norm_(tps, 1.0, norm_type)
    np.testing.assert_allclose(float(tt), float(np.asarray(jt._data)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp._grad),
                                   **TOL)
    tps[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        tclip.clip_grad_norm_(tps, 1.0, error_if_nonfinite=True)


def test_optimizer_api_surface():
    _, tps = _params(_arrays(9))
    opt = topt.Momentum(learning_rate=0.1, parameters=tps, device="cpu")
    assert opt.get_lr() == 0.1
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    loss = sum((p * p).sum() for p in tps)
    opt.minimize(loss)
    assert opt._global_step == 1 and tps[0].grad is not None
    opt.clear_grad(set_to_zero=True)
    assert float(tps[0].grad.abs().sum()) == 0.0
    opt.clear_grad()
    assert all(p.grad is None for p in tps)
    opt.apply_gradients([(p, torch.ones_like(p)) for p in tps])
    assert opt._global_step == 2
    sched_opt = topt.SGD(learning_rate=topt.lr.StepDecay(0.1, 2),
                         parameters=tps, device="cpu")
    with pytest.raises(RuntimeError):
        sched_opt.set_lr(0.3)
    with pytest.raises(TypeError):
        topt.AdamW(parameters=tps, weight_decay="x", device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        topt.SGD(device="cpu")


def test_entry_points_run_on_cuda_or_raise(monkeypatch):
    """With no device given, the optimizers and Model ask for CUDA; without
    it they raise instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tps = _params(_arrays(10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        topt.AdamW(parameters=tps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Model(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="device"):
        topt.SGD(parameters=tps, device="meta")
