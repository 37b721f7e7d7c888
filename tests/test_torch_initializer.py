"""The port's ``nn.initializer``, ``ParamAttr`` and
``Layer.create_parameter`` against the JAX package on the CPU: the
deterministic initializers (``Constant``, ``Assign``, ``Bilinear``,
``Dirac``) and ``calculate_gain`` equal; every initializer's shape and
dtype, and the random ones' bounds from their fans; ``create_parameter``
setting ``optimize_attr``, ``regularizer``, ``need_clip`` and
``trainable`` as the reference does; every ported layer that takes
``weight_attr``/``bias_attr`` built from a ``ParamAttr`` or an initializer
giving the JAX package's forward; and a step where ``need_clip`` and a
``ParamAttr`` regularizer act, equal to the JAX package's. The random
initializers' determinism under ``seed`` and their moments are held in
``test_torch_ops_creation_linalg.py``."""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core.dtypes import dtype_name  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


ARR = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0


@pytest.mark.parametrize("make,shape", [
    (lambda I: I.Constant(0.5), [2, 3]),
    (lambda I: I.Assign(ARR), [3, 4]),
    (lambda I: I.Assign(ARR), [4, 3]),
    (lambda I: I.Assign(ARR.tolist()), [12]),
    (lambda I: I.Bilinear(), [2, 1, 4, 4]),
    (lambda I: I.Bilinear(), [1, 1, 3, 5]),
    (lambda I: I.Dirac(), [4, 2, 3, 3]),
    (lambda I: I.Dirac(groups=2), [4, 4, 3]),
    (lambda I: I.NumpyArrayInitializer(ARR), [3, 4]),
    (lambda I: I.ConstantInitializer(-1.5), [5]),
], ids=["constant", "assign", "assign_reshaped", "assign_list",
        "bilinear", "bilinear_odd", "dirac", "dirac_groups", "numpy_alias",
        "constant_alias"])
def test_deterministic_initializers_match_jax(make, shape):
    got = make(P.nn.initializer)(shape)
    want = make(J.nn.initializer)(shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert got.device.type == "cpu"


def test_assign_takes_a_tensor_and_keeps_float64():
    t = P.to_tensor(ARR)
    out = P.nn.initializer.Assign(t)([3, 4], "float64")
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), ARR.astype(np.float64))
    x64 = np.linspace(0, 1, 5)
    np.testing.assert_array_equal(
        P.nn.initializer.Assign(x64)([5], "float64").numpy(), x64)


@pytest.mark.parametrize("nl,param", [("tanh", None), ("relu", None),
                                      ("leaky_relu", None),
                                      ("leaky_relu", 0.2), ("selu", None),
                                      ("linear", None), ("sigmoid", None)])
def test_calculate_gain_matches_jax(nl, param):
    assert P.nn.initializer.calculate_gain(nl, param) == \
        J.nn.initializer.calculate_gain(nl, param)


@pytest.mark.parametrize("name", [
    "Constant", "Uniform", "Normal", "TruncatedNormal", "XavierUniform",
    "XavierNormal", "KaimingUniform", "KaimingNormal", "Orthogonal",
    "Bilinear", "Dirac"])
@pytest.mark.parametrize("dtype", [None, "float64"])
def test_every_initializer_gives_the_shape_and_dtype(name, dtype):
    shape = [4, 3, 3, 3]
    got = getattr(P.nn.initializer, name)()(shape, dtype)
    want = getattr(J.nn.initializer, name)()(shape, dtype)
    assert list(got.shape) == list(want.shape)
    d = dtype_name(got.dtype)
    assert {"float64": "float32"}.get(d, d) == np.dtype(want.dtype).name


@pytest.mark.parametrize("make,limit", [
    (lambda I: I.XavierUniform(), math.sqrt(6.0 / (3 * 9 + 4 * 9))),
    (lambda I: I.XavierUniform(fan_in=10, fan_out=20, gain=2.0),
     2.0 * math.sqrt(6.0 / 30)),
    (lambda I: I.KaimingUniform(), math.sqrt(2.0) * math.sqrt(3.0 / 27)),
    (lambda I: I.KaimingUniform(negative_slope=0.1,
                                nonlinearity="leaky_relu"),
     math.sqrt(2.0 / 1.01) * math.sqrt(3.0 / 27)),
    (lambda I: I.Uniform(-0.3, 0.2), 0.3),
], ids=["xavier", "xavier_fans", "kaiming", "kaiming_leaky", "uniform"])
def test_uniform_initializers_respect_their_fans(make, limit):
    P.seed(3)
    got = _np(make(P.nn.initializer)([4, 3, 3, 3]))
    assert np.abs(got).max() <= limit + 1e-6
    assert np.abs(got).max() > 0.5 * limit


def test_initializer_draws_from_a_given_generator():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    I = P.nn.initializer
    a = I.Normal(0.0, 1.0)([3, 4], generator=g1)
    b = I.Normal(0.0, 1.0)([3, 4], generator=g2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("attr_kind", ["param_attr", "initializer", "name",
                                       "none", "false"])
def test_create_parameter_reads_the_attr_as_the_reference(attr_kind):
    reg_p, reg_j = P.regularizer.L2Decay(0.1), J.regularizer.L2Decay(0.1)

    def attr(m, reg):
        return {"param_attr": m.ParamAttr(
                    name="w0", initializer=m.nn.initializer.Assign(ARR),
                    learning_rate=0.5, regularizer=reg, trainable=False,
                    need_clip=False),
                "initializer": m.nn.initializer.Constant(0.25),
                "name": "w1", "none": None, "false": False}[attr_kind]

    pl, jl = P.nn.Layer(), J.nn.Layer()
    p = pl.create_parameter([3, 4], attr(P, reg_p), is_bias=True)
    j = jl.create_parameter([3, 4], attr(J, reg_j), is_bias=True)
    if attr_kind == "false":
        assert p is None and j is None
        return
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j.numpy()),
                               **TOL)
    assert p.optimize_attr == j.optimize_attr
    assert p.need_clip == j.need_clip
    assert p.trainable == j.trainable
    assert (p.regularizer is reg_p) == (j.regularizer is reg_j)
    if attr_kind in ("param_attr", "name"):
        assert p.name == j.name


def test_create_parameter_defaults_to_xavier_weights():
    P.seed(1)
    w = P.nn.Layer().create_parameter([30, 40])
    limit = math.sqrt(6.0 / 70)
    assert np.abs(w.detach().numpy()).max() <= limit + 1e-7
    assert isinstance(w, P.Parameter) and w.trainable


def _layer_pair(name):
    """The same layer in both packages with ParamAttr / initializer
    attributes, and its input."""
    rng = np.random.default_rng(9)

    def attrs(m):
        I = m.nn.initializer
        return dict(weight_attr=m.ParamAttr(initializer=I.Constant(0.05)),
                    bias_attr=I.Constant(-0.1))

    def make(m):
        kw = {} if m is J else {"device": "cpu"}
        a = attrs(m)
        I = m.nn.initializer
        wrng = np.random.default_rng(1)
        if name == "Linear":
            w = wrng.standard_normal((4, 3)).astype(np.float32)
            return m.nn.Linear(4, 3, weight_attr=m.ParamAttr(
                initializer=I.Assign(w)), bias_attr=I.Constant(0.3), **kw)
        if name == "Embedding":
            w = wrng.standard_normal((6, 3)).astype(np.float32)
            return m.nn.Embedding(6, 3, weight_attr=m.ParamAttr(
                initializer=I.Assign(w)), **kw)
        if name == "LayerNorm":
            return m.nn.LayerNorm(4, weight_attr=I.Constant(2.0),
                                  bias_attr=m.ParamAttr(
                                      initializer=I.Constant(0.5)), **kw)
        if name == "Conv2D":
            return m.nn.Conv2D(2, 3, 3, padding=1, **a, **kw)
        if name == "BatchNorm2D":
            return m.nn.BatchNorm2D(2, weight_attr=I.Constant(1.5),
                                    bias_attr=I.Constant(0.2), **kw)
        if name == "BatchNorm1D":
            return m.nn.BatchNorm1D(3, weight_attr=I.Constant(0.5),
                                    bias_attr=False, **kw)
        if name == "MultiHeadAttention":
            return m.nn.MultiHeadAttention(8, 2, **a, **kw)
        if name == "TransformerEncoderLayer":
            return m.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0, **a,
                                                **kw)
        if name == "TransformerDecoderLayer":
            return m.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0, **a,
                                                **kw)
        if name == "Transformer":
            return m.nn.Transformer(8, 2, 1, 1, 16, dropout=0.0, **a, **kw)
        raise KeyError(name)

    inputs = {
        "Linear": [rng.standard_normal((2, 4))],
        "Embedding": [rng.integers(0, 6, (2, 5))],
        "LayerNorm": [rng.standard_normal((2, 3, 4))],
        "Conv2D": [rng.standard_normal((1, 2, 4, 4))],
        "BatchNorm2D": [rng.standard_normal((2, 2, 3, 3))],
        "BatchNorm1D": [rng.standard_normal((4, 3))],
        "MultiHeadAttention": [rng.standard_normal((2, 3, 8))],
        "TransformerEncoderLayer": [rng.standard_normal((2, 3, 8))],
        "TransformerDecoderLayer": [rng.standard_normal((2, 3, 8)),
                                    rng.standard_normal((2, 4, 8))],
        "Transformer": [rng.standard_normal((2, 3, 8)),
                        rng.standard_normal((2, 4, 8))],
    }[name]
    inputs = [x.astype(np.float32) if x.dtype.kind == "f" else x
              for x in inputs]
    return make(P), make(J), inputs


LAYERS = ["Linear", "Embedding", "LayerNorm", "Conv2D", "BatchNorm2D",
          "BatchNorm1D", "MultiHeadAttention", "TransformerEncoderLayer",
          "TransformerDecoderLayer", "Transformer"]


@pytest.mark.parametrize("name", LAYERS)
def test_layers_take_param_attrs_and_initializers(name):
    p, j, inputs = _layer_pair(name)
    p.eval()
    j.eval()
    got = p(*[P.to_tensor(x) for x in inputs])
    want = j(*[J.to_tensor(x) for x in inputs])
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    pn = {k: v.shape for k, v in p.named_parameters()}
    jn = {k: tuple(v.shape) for k, v in j.named_parameters()}
    assert {k: tuple(v) for k, v in pn.items()} == jn
    # reset_parameters re-applies each attribute's initializer
    from paddle_tpu_torch.nn.layers_common import reset_parameters
    before = {k: v.detach().clone() for k, v in p.named_parameters()}
    g = torch.Generator()
    g.manual_seed(0)
    reset_parameters(p, g)
    for k, v in p.named_parameters():
        assert torch.equal(before[k], v.detach()), k


def test_need_clip_and_regularizer_attrs_act_in_a_step():
    """Two Linear layers, one with ``need_clip=False`` and an L2Decay
    regularizer through ParamAttr, under ClipGradByGlobalNorm and
    Momentum: the updated weights equal the JAX package's."""
    rng = np.random.default_rng(11)
    w1 = rng.standard_normal((4, 5)).astype(np.float32)
    w2 = rng.standard_normal((5, 2)).astype(np.float32)
    x = rng.standard_normal((3, 4)).astype(np.float32) * 3

    def run(m):
        I = m.nn.initializer
        kw = {} if m is J else {"device": "cpu"}
        a = m.nn.Linear(4, 5, weight_attr=m.ParamAttr(
            initializer=I.Assign(w1), need_clip=False,
            regularizer=m.regularizer.L2Decay(0.5)), **kw)
        b = m.nn.Linear(5, 2, weight_attr=I.Assign(w2), **kw)
        params = list(a.parameters()) + list(b.parameters())
        okw = {} if m is J else {"device": "cpu"}
        opt = m.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=params,
            grad_clip=m.nn.ClipGradByGlobalNorm(0.1), **okw)
        for _ in range(2):
            loss = (b(a(m.to_tensor(x))) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        return [_np(p) for p in params]

    for got, want in zip(run(P), run(J)):
        np.testing.assert_allclose(got, want, **TOL)
