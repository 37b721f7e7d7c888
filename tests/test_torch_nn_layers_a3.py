"""The port's A3 layers (``nn/layers_common.py``,
``nn/container.py``, ``nn/utils_weight_norm.py``) against the JAX
package's on the CPU: every case of the layer table's common part
(``tests/test_torch_op_table.py`` ``LAYER_CASES``; its activation and
loss layers are ``test_torch_layer_api.py``'s) built in both packages, the JAX package's parameters
and buffers carried to the port by ``state_dict_from_reference`` and
``set_state_dict``, then the same seeded inputs: outputs and the state
after the call (running statistics) at 1e-5, the gradients of a seeded
cotangent for the inputs and every parameter at 1e-4, parameter and
state names equal. Then the reference's own layer cases
(``tests/test_nn_layers.py``) and the ``nn`` namespace's names."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_op_table import (LAYER_CASES, _np_of,  # noqa: E402
                                 assert_layer_case_close, run_layer_case)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def check_layer_against_jax(case):
    """``case`` built in both packages from the JAX package's state
    (module docstring)."""
    J.seed(7)
    ref_state = {k: _np_of(v) for k, v in case.build(J).state_dict().items()}
    ref = run_layer_case(J, case, state=ref_state)
    state = P.state_dict_from_reference(ref_state, device="cpu")
    got = run_layer_case(P, case, state=state)
    assert_layer_case_close(case, got, ref, "port vs JAX")


@pytest.mark.parametrize("case", [c for c in LAYER_CASES
                                  if c.module == "common"], ids=repr)
def test_layer_matches_jax(case):
    check_layer_against_jax(case)


def _pair(x):
    return J.to_tensor(x), P.to_tensor(x)


def test_conv_and_transposed_conv_layers_match_jax():
    """``tests/test_nn_layers.py:24-75``: conv2d with groups and
    dilation, depthwise, the transposed conv, through the functionals."""
    rng = np.random.default_rng(0)
    x = rng.random((1, 4, 10, 10), dtype=np.float32)
    w = rng.random((8, 2, 3, 3), dtype=np.float32)
    jo = J.nn.functional.conv2d(*_pair(x)[:1], J.to_tensor(w), groups=2,
                                dilation=2, padding=2).numpy()
    to = P.nn.functional.conv2d(P.to_tensor(x), P.to_tensor(w), groups=2,
                                dilation=2, padding=2).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    x = rng.random((1, 4, 5, 5), dtype=np.float32)
    w = rng.random((4, 3, 3, 3), dtype=np.float32)
    jo = J.nn.functional.conv2d_transpose(J.to_tensor(x), J.to_tensor(w),
                                          stride=2, padding=1).numpy()
    to = P.nn.functional.conv2d_transpose(P.to_tensor(x), P.to_tensor(w),
                                          stride=2, padding=1).numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)


def test_batch_norm_train_eval_and_group_norm_match_jax():
    """``tests/test_nn_layers.py:103-134``: BatchNorm2D's running
    statistics after a training call, then eval; GroupNorm."""
    x = np.random.default_rng(1).random((4, 3, 5, 5), dtype=np.float32)
    jb, tb = J.nn.BatchNorm2D(3), P.nn.BatchNorm2D(3)
    np.testing.assert_allclose(tb(P.to_tensor(x)).numpy(),
                               jb(J.to_tensor(x)).numpy(), atol=1e-5)
    np.testing.assert_allclose(tb._variance.numpy(), jb._variance.numpy(),
                               atol=1e-6)
    jb.eval(), tb.eval()
    np.testing.assert_allclose(tb(P.to_tensor(x)).numpy(),
                               jb(J.to_tensor(x)).numpy(), atol=1e-5)
    jg, tg = J.nn.GroupNorm(3, 6), P.nn.GroupNorm(3, 6)
    x = np.random.default_rng(2).random((2, 6, 4, 4), dtype=np.float32)
    np.testing.assert_allclose(tg(P.to_tensor(x)).numpy(),
                               jg(J.to_tensor(x)).numpy(), atol=1e-5)


def test_nn_namespace_holds_the_reference_names():
    """Every public name of the JAX package's ``nn`` and
    ``nn.functional`` that this slice ports, in the same namespaces,
    ``FLASH_CROSSOVER`` (a TPU constant) and the recurrent layers (queue
    A9) aside."""
    skip = {"FLASH_CROSSOVER", "RNNCellBase", "SimpleRNNCell", "LSTMCell",
            "GRUCell", "RNN", "SimpleRNN", "LSTM", "GRU", "BiRNN", "rnn"}
    names = {n for n in dir(J.nn) if not n.startswith("_")} - skip
    assert not sorted(n for n in names if not hasattr(P.nn, n))
    for mod in ("conv", "pooling"):
        ref = getattr(J.nn.functional, mod)
        fns = [n for n in dir(ref) if not n.startswith("_")
               and callable(getattr(ref, n)) and
               getattr(getattr(ref, n), "__module__", "") == ref.__name__]
        assert fns and not [n for n in fns
                            if not hasattr(P.nn.functional, n)], mod
    assert {"weight_norm", "remove_weight_norm", "spectral_norm",
            "parameters_to_vector", "vector_to_parameters"} <= set(
                dir(P.nn.utils))
    assert P.nn.loss.MSELoss is P.nn.MSELoss
    for name in ("MobileNetV1", "MobileNetV2", "MobileNetV3Large",
                 "MobileNetV3Small", "mobilenet_v1", "mobilenet_v2",
                 "mobilenet_v3_large", "mobilenet_v3_small"):
        assert hasattr(P.vision.models, name), name


def test_hardsigmoid_keeps_the_reference_slope():
    """``Hardsigmoid`` is the port's ``F.hardsigmoid`` (slope 0.1666667),
    not ``torch.nn.Hardsigmoid`` (1/6): equal to the JAX package's
    bitwise near the kink, where the slopes part."""
    x = np.linspace(-2.9, 2.9, 59).astype(np.float32)
    got = P.nn.Hardsigmoid()(P.to_tensor(x)).numpy()
    ref = J.nn.Hardsigmoid()(J.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    assert not np.allclose(got, torch.nn.Hardsigmoid()(
        torch.from_numpy(x)).numpy(), rtol=0, atol=1e-8)


def test_parameters_to_vector_round_trip():
    a, b = P.nn.Linear(3, 4), P.nn.Linear(3, 4)
    vec = P.nn.utils.parameters_to_vector(a.parameters())
    assert tuple(vec.shape) == (16,)
    P.nn.utils.vector_to_parameters(vec, b.parameters())
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    jl = J.nn.Linear(3, 4)
    jvec = J.nn.utils.parameters_to_vector(jl.parameters()).numpy()
    a.set_state_dict(P.state_dict_from_reference(
        {k: _np_of(v) for k, v in jl.state_dict().items()}, "cpu"))
    np.testing.assert_array_equal(
        _np_of(P.nn.utils.parameters_to_vector(a.parameters())), jvec)


def test_functional_spectral_norm_matches_jax_where_the_iteration_converges():
    """The stateless ``spectral_norm`` starts its power iteration at a
    Gaussian draw of its own, not the JAX package's ``PRNGKey(0)``: on a
    weight with a clear gap between its top two singular values both
    reach the top one in their 20 iterations."""
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    v, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    s = np.zeros((6, 5))
    s[np.arange(5), np.arange(5)] = [5.0, 1.0, 0.8, 0.5, 0.1]
    w = (u @ s @ v.T).astype(np.float32).reshape(6, 5, 1)
    got = P.nn.spectral_norm(P.to_tensor(w), dim=0).numpy()
    ref = J.nn.spectral_norm(J.to_tensor(w), dim=0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.svd(got[..., 0])[1][0], 1.0,
                               rtol=1e-5)


def test_remove_weight_norm_keeps_the_normalised_weight():
    """After ``remove_weight_norm`` the weight is ``g * v / ||v||``
    (the JAX package's keeps ``v``, the same value while ``g`` is
    ``||v||``)."""
    lin = P.nn.utils.weight_norm(P.nn.Linear(3, 4), dim=1)
    with torch.no_grad():
        lin.weight_g.mul_(2.0)
    x = P.to_tensor(np.ones((2, 3), np.float32))
    before = lin(x).numpy()
    P.nn.utils.remove_weight_norm(lin)
    assert sorted(n for n, _ in lin.named_parameters()) == ["bias",
                                                            "weight"]
    np.testing.assert_allclose(lin(x).numpy(), before, rtol=1e-6)


@pytest.mark.parametrize("m", [J, P], ids=["jax", "port"])
def test_reference_parity_cases_in_both_packages(m):
    """``tests/test_nn_parity_r5.py:103-174`` and
    ``tests/test_op_tail_r5b.py:289-308`` in both packages: the
    ``HSigmoidLoss`` layer equals its functional, ``PairwiseDistance``
    NumPy's norm, the stateless ``spectral_norm`` repeats itself and
    divides by the top singular value, ``SyncBatchNorm`` in one process
    equals ``BatchNorm2D``, ``SpectralNorm`` after 50 iterations too."""
    nn, F = m.nn, m.nn.functional
    m.seed(1)
    lay = nn.HSigmoidLoss(8, 6)
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    lab = np.random.RandomState(1).randint(0, 6, (4,)).astype(np.int64)
    out = lay(m.to_tensor(x), m.to_tensor(lab))
    ref = F.hsigmoid_loss(m.to_tensor(x), m.to_tensor(lab), 6,
                          lay.weight, lay.bias)
    np.testing.assert_allclose(_np_of(out), _np_of(ref), rtol=1e-6)
    a = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    b = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(
        _np_of(nn.PairwiseDistance(p=2.0)(m.to_tensor(a), m.to_tensor(b))),
        np.linalg.norm(a - b + 1e-6, axis=-1), rtol=1e-5)
    w = np.random.RandomState(6).randn(6, 4).astype(np.float32)
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    s1 = _np_of(nn.spectral_norm(m.to_tensor(w)))
    np.testing.assert_array_equal(s1, _np_of(nn.spectral_norm(
        m.to_tensor(w))))
    np.testing.assert_allclose(s1, w / sigma, rtol=1e-3, atol=1e-4)
    sn = nn.SpectralNorm([6, 4], dim=0, power_iters=50)
    np.testing.assert_allclose(_np_of(sn(m.to_tensor(w))), w / sigma,
                               rtol=1e-3, atol=1e-4)
    m.seed(13)
    sbn, bn = nn.SyncBatchNorm(4), nn.BatchNorm2D(4)
    bn.set_state_dict(sbn.state_dict())
    x = np.random.RandomState(14).randn(3, 4, 5, 5).astype(np.float32)
    np.testing.assert_allclose(_np_of(sbn(m.to_tensor(x))),
                               _np_of(bn(m.to_tensor(x))), rtol=1e-4,
                               atol=1e-5)
