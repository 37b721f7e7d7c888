"""The port's Adamax, Adagrad, Adadelta, RMSProp (plain and centered),
Lamb, LarsMomentum and Ftrl against the JAX package's: the same NumPy
parameters and gradients through both (one parameter zero, so Lamb's
trust ratio and LarsMomentum's local lr take their zero-norm branch on
step 1, as zero-initialized biases do), parameters and state at 1e-5
after one step and ten, the state-dict keys equal, ``.pdopt`` files
moving both ways; ten ``Model.train_batch`` steps of a tiny MLP (zero
biases) through each, losses at 1e-4, with ``train_loop`` falling back to
``train_batch`` (``_fused_loop`` None: none of the seven is elementwise,
as in the reference); Lamb's ``exclude_from_weight_decay_fn`` gate."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import framework_io as jio  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core.tensor import Parameter as JParameter  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io as tio  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402

SHAPES = [(6, 5), (5,), (3, 4, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
CURVE_TOL = 1e-4

# name -> (class, kwargs)
RULES = {
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05,
                                initial_accumulator_value=0.1)),
    "adadelta": ("Adadelta", dict(learning_rate=0.5, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01)),
    "lars": ("LarsMomentum", dict(learning_rate=0.1, lars_coeff=0.01)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1)),
    "ftrl_l1_l2": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.02)),
}


def _values(seed):
    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    vals[1][:] = 0.0        # a zero-initialized bias
    return vals


def _pair(rule, values):
    cls, kw = RULES[rule]
    jps = [JParameter(jnp.asarray(v)) for v in values]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    jo = getattr(jopt, cls)(parameters=jps, **kw)
    to = getattr(topt, cls)(parameters=tps, device="cpu", **kw)
    return jps, tps, jo, to


def _step(rng, opts, ps_list, zero_first=False):
    grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if zero_first:
        grads[1][:] = 0.0
    for opt, ps in zip(opts, ps_list):
        for p, g in zip(ps, grads):
            if isinstance(p, torch.Tensor):
                p.grad = torch.from_numpy(g)
            else:
                p._grad = jnp.asarray(g)
        opt.step()


def _assert_state_close(jo, to):
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        if k.startswith("param_"):
            np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v._data),
                                       **TOL, err_msg=k)
    assert tsd["global_step"] == jsd["global_step"]


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule, steps):
    jps, tps, jo, to = _pair(rule, _values(0))
    rng = np.random.default_rng(100)
    for i in range(steps):
        _step(rng, [jo, to], [jps, tps], zero_first=(i == 0))
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)
    _assert_state_close(jo, to)


def test_state_keys_are_the_references():
    keys = {}
    for rule in ("adamax", "adagrad", "adadelta", "rmsprop",
                 "rmsprop_centered", "lamb", "lars", "ftrl"):
        _, _, _, to = _pair(rule, _values(0))
        keys[rule] = sorted(k.split(".", 1)[1] for k in to.state_dict()
                            if k.startswith("param_0."))
    assert keys == {
        "adamax": ["inf_norm", "moment"], "adagrad": ["moment"],
        "adadelta": ["avg_sq_grad", "avg_sq_update"],
        "rmsprop": ["mean_square", "momentum"],
        "rmsprop_centered": ["mean_grad", "mean_square", "momentum"],
        "lamb": ["moment1", "moment2"], "lars": ["velocity"],
        "ftrl": ["linear", "squared"]}


@pytest.mark.parametrize("rule", ["lamb", "lars"])
def test_zero_norm_branch(rule):
    """A zero parameter with a zero gradient: Lamb's trust ratio is 1 and
    LarsMomentum's local lr is the lr (no NaN from 0 / 0)."""
    cls, kw = RULES[rule]
    p = torch.nn.Parameter(torch.zeros(4))
    q = torch.nn.Parameter(torch.ones(3))
    opt = getattr(topt, cls)(parameters=[p, q], device="cpu", **kw)
    p.grad = torch.zeros(4)
    q.grad = torch.full((3,), 0.5)
    opt.step()
    assert torch.equal(p.detach(), torch.zeros(4))
    assert torch.isfinite(q.detach()).all()
    p.grad = torch.ones(4)          # |p| still 0, |g| > 0
    opt.step()
    if rule == "lars":
        # velocity 0.9 * 0 + lr * (g + wd * 0), lr not scaled
        np.testing.assert_allclose(p.detach().numpy(), -0.1, rtol=1e-6)
    else:
        assert torch.isfinite(p.detach()).all() and (p.detach() != 0).all()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_pdopt_round_trip(tmp_path, rule, direction):
    values = _values(3)
    jps, tps, jo, to = _pair(rule, values)
    rng = np.random.default_rng(8)
    path = str(tmp_path / "opt.pdopt")
    if direction == "port_to_jax":
        for _ in range(3):
            _step(rng, [to], [tps])
        tio.save(to.state_dict(), path)
        for jp, tp in zip(jps, tps):
            jp._data = jnp.asarray(tp.detach().numpy())
        jo.set_state_dict(jio.load(path))
    else:
        for _ in range(3):
            _step(rng, [jo], [jps])
        jio.save(jo.state_dict(), path)
        with torch.no_grad():
            for jp, tp in zip(jps, tps):
                tp.copy_(torch.from_numpy(np.array(jp._data)))
        to.set_state_dict(tio.load(path))
    assert to._global_step == jo._global_step == 3
    _assert_state_close(jo, to)
    for _ in range(2):
        _step(rng, [jo, to], [jps, tps])
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                                   **TOL)


def test_lamb_exclude_from_weight_decay_fn_is_refused():
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(NotImplementedError, match="never reads it"):
        topt.Lamb(parameters=[p], device="cpu",
                  exclude_from_weight_decay_fn=lambda n: "bias" in n)
    topt.Lamb(parameters=[p], device="cpu",
              exclude_from_weight_decay_fn=None)


def _mlp(pkg):
    if pkg == "jax":
        return jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                              jnn.Linear(16, 4))
    return tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                          tnn.Linear(16, 4, device="cpu"))


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_through_model_train_batch_matches_jax(rule):
    """Ten compiled ``train_batch`` steps of a tiny MLP whose biases start
    at zero; then ``train_loop`` falls back to ``train_batch`` and
    continues the same curve."""
    cls, kw = RULES[rule]
    paddle.seed(0)
    jnet = _mlp("jax")
    arrays = {k: np.array(v._data) for k, v in jnet.state_dict().items()}
    for k in arrays:
        if k.endswith("bias"):
            arrays[k][:] = 0.0
    jnet.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    tnet = _mlp("torch")
    tnet.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    jm = paddle.Model(jnet)
    jm.prepare(getattr(jopt, cls)(parameters=jnet.parameters(), **kw),
               jnn.CrossEntropyLoss())
    tm = P.Model(tnet, device="cpu")
    tm.prepare(getattr(topt, cls)(parameters=tnet.parameters(),
                                  device="cpu", **kw),
               tnn.CrossEntropyLoss())
    rng = np.random.RandomState(1)
    xs = rng.randn(12, 8, 8).astype(np.float32)
    ys = rng.randint(0, 4, (12, 8, 1)).astype(np.int64)
    jl = [jm.train_batch([xs[i]], [ys[i]])[0] for i in range(10)]
    tl = [tm.train_batch([xs[i]], [ys[i]])[0] for i in range(10)]
    assert (np.abs(np.array(tl) - jl) / np.abs(jl)).max() < CURVE_TOL
    jl += jm.train_loop([xs[10:]], [ys[10:]])
    tl += tm.train_loop([xs[10:]], [ys[10:]])
    assert tm._fused_loop is None
    assert (np.abs(np.array(tl) - jl) / np.abs(jl)).max() < CURVE_TOL
    for k, v in tnet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jnet.state_dict()[k]._data), **TOL, err_msg=k)
