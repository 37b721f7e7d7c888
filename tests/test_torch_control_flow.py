"""The port's control flow (``paddle_tpu_torch/ops/control_flow.py``) on
the CPU: the JAX package's eager cases (``tests/test_control_flow.py``)
through both packages; the capture lane, where ``cond``, ``case`` and
``switch_case`` run every branch and select, held against the eager lane
and the JAX package (a branch not taken that takes ``sqrt`` of a
negative input leaves no NaN in the gradient); a ``Model.train_batch``
whose forward calls ``ops.cond`` (``tests/test_control_flow.py:99-124``)
equal in both lanes and to the JAX package's; ``while_loop`` refused in a
capture; the tensor arrays and ``increment``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_op_table import cond_net  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture(params=["eager", "capture"])
def lane(request, monkeypatch):
    """Each test in the eager lane and as the port runs inside a CUDA
    graph capture."""
    if request.param == "capture":
        monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    return request.param


@pytest.mark.parametrize("m,capture", [(P, False), (P, True), (J, False)],
                         ids=["port", "port_capture", "jax"])
def test_cond_dispatch_and_gradient(m, capture, monkeypatch):
    if capture:
        monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    x = m.to_tensor(np.array([2.0], np.float32))
    out = m.ops.cond(m.mean(x) > 1.0, lambda: x * 2, lambda: x - 1)
    np.testing.assert_allclose(out.numpy(), [4.0])
    out = m.ops.cond(m.mean(x) > 3.0, lambda: x * 2, lambda: x - 1)
    np.testing.assert_allclose(out.numpy(), [1.0])
    x = m.to_tensor(np.array([3.0], np.float32), stop_gradient=False)
    out = m.ops.cond(x.sum() > 0, lambda: x * x, lambda: x)
    out.backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_branch_not_taken_leaves_no_nan_in_the_gradient(lane):
    """``sqrt`` of a negative input in the branch not taken: NaN in its
    value and its backward, neither reaching the result or the gradient
    (``lax.cond`` never runs the other branch's backward)."""
    x = P.to_tensor(np.array([-1.0, -4.0], np.float32), stop_gradient=False)
    out = P.ops.cond(x.sum() < 0, lambda: x * 3.0, lambda: P.sqrt(x))
    (out * out).sum().backward()
    np.testing.assert_array_equal(out.numpy(), [-3.0, -12.0])
    np.testing.assert_array_equal(x.grad.numpy(), [-18.0, -72.0])
    jx = J.to_tensor(np.array([-1.0, -4.0], np.float32), stop_gradient=False)
    jout = J.ops.cond(jx.sum() < 0, lambda: jx * 3.0, lambda: J.sqrt(jx))
    (jout * jout).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(
        jx.grad.numpy()))


def test_nested_branches_gate_by_both_predicates(lane):
    y = P.to_tensor(np.float32(5.0), stop_gradient=False)
    o = P.ops.case([(y > 10.0, lambda: y * 0),
                    (y > 3.0, lambda: y * 2)], default=lambda: P.sqrt(-y))
    o2 = P.ops.switch_case(P.to_tensor(np.int32(1)),
                           {0: lambda: y + 1, 1: lambda: y * y},
                           default=lambda: P.log(-y))
    (o + o2).backward()
    assert float(o) == 10.0 and float(o2) == 25.0
    assert float(y.grad) == 12.0


@pytest.mark.parametrize("m", [P, J], ids=["port", "jax"])
def test_case_and_switch_case(m):
    x = m.to_tensor(np.float32(5.0))
    out = m.ops.case([(x > 10.0, lambda: x * 0), (x > 3.0, lambda: x * 2)],
                     default=lambda: x)
    assert float(out.numpy()) == 10.0
    idx = m.to_tensor(np.int32(1))
    out = m.ops.switch_case(idx, {0: lambda: x + 1, 1: lambda: x + 2},
                            default=lambda: x)
    assert float(out.numpy()) == 7.0
    out = m.ops.switch_case(m.to_tensor(np.int32(5)),
                            [lambda: x + 1, lambda: x + 3])
    assert float(out.numpy()) == 8.0       # no match: the last branch


def test_capture_lane_selects_output_trees():
    x = P.to_tensor(np.array([1.0, 2.0], np.float32))

    def run():
        return P.ops.cond(x.sum() > 0, lambda: (x + 1, [x * 2, 3]),
                          lambda: (x - 1, [x * 0, 3]))
    eager = run()
    tdispatch_capturing = tdispatch.capturing
    try:
        tdispatch.capturing = lambda: True
        sel = run()
        with pytest.raises(TypeError, match="structures"):
            P.ops.cond(x.sum() > 0, lambda: x, lambda: (x, x))
        with pytest.raises(TypeError, match="type"):
            P.ops.cond(x.sum() > 0, lambda: x, lambda: x.astype("int64"))
    finally:
        tdispatch.capturing = tdispatch_capturing
    np.testing.assert_array_equal(sel[0].numpy(), eager[0].numpy())
    np.testing.assert_array_equal(sel[1][0].numpy(), eager[1][0].numpy())
    assert sel[1][1] == 3 and isinstance(sel[0], P.Tensor)


@pytest.mark.parametrize("m", [P, J], ids=["port", "jax"])
def test_while_loop_eager(m):
    i = m.to_tensor(np.float32(0.0))
    s = m.to_tensor(np.float32(0.0))
    i2, s2 = m.ops.while_loop(lambda i, s: i < 5.0,
                              lambda i, s: [i + 1.0, s + i], [i, s])
    assert float(i2.numpy()) == 5.0 and float(s2.numpy()) == 10.0
    w = m.to_tensor(np.float32(1.5), stop_gradient=False)
    _, y = m.ops.while_loop(lambda c, v: c < 3.0,
                            lambda c, v: [c + 1.0, v * w],
                            [m.to_tensor(np.float32(0.0)),
                             m.to_tensor(np.float32(1.0))])
    y.backward()
    np.testing.assert_allclose(float(w.grad.numpy()), 3 * 1.5 ** 2,
                               rtol=1e-5)


def test_while_loop_refused_under_capture(monkeypatch):
    monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    with pytest.raises(NotImplementedError, match="trip count"):
        P.ops.while_loop(lambda i: i < 3.0, lambda i: [i + 1.0],
                         [P.to_tensor(np.float32(0.0))])


@pytest.mark.parametrize("op", ["cond", "while_loop", "case",
                                "switch_case"])
def test_static_program_control_flow_raises(monkeypatch, op):
    monkeypatch.setattr(tdispatch, "in_dygraph_mode", lambda: False)
    x = P.to_tensor(np.float32(1.0))
    call = {"cond": lambda: P.ops.cond(x > 0, lambda: x, lambda: x),
            "while_loop": lambda: P.ops.while_loop(
                lambda v: v < 2.0, lambda v: [v + 1.0], [x]),
            "case": lambda: P.ops.case([(x > 0, lambda: x)]),
            "switch_case": lambda: P.ops.switch_case(0, [lambda: x])}[op]
    with pytest.raises(NotImplementedError, match="A11"):
        call()


@pytest.mark.parametrize("m", [P, J], ids=["port", "jax"])
def test_arrays_and_increment(m):
    arr = m.ops.create_array("float32")
    x = m.to_tensor(np.array([1.0, 2.0], np.float32))
    m.ops.array_write(x, m.to_tensor(np.int64(2)), arr)
    assert len(arr) == 3 and arr[0] is None
    assert m.ops.array_read(arr, 2) is x
    assert int(m.ops.array_length(arr).numpy()) == 3
    c = m.to_tensor(np.array([1.0], np.float32))
    out = m.ops.increment(c, 2.5)
    assert out is c and float(c.numpy()[0]) == 3.5
    assert m.increment is m.ops.increment


class _MeanSquare:
    def __init__(self, m):
        self.m = m

    def __call__(self, pred, y):
        return self.m.mean((pred - y) ** 2)


def _train(m, net, X, Y, steps=5):
    model = m.Model(net)
    model.prepare(m.optimizer.SGD(learning_rate=0.1,
                                  parameters=net.parameters()),
                  _MeanSquare(m))
    return [model.train_batch([m.to_tensor(X)], [m.to_tensor(Y)])[0]
            for _ in range(steps)]


def test_cond_train_step_in_both_lanes_matches_jax(monkeypatch):
    rng = np.random.RandomState(0)
    X = rng.rand(8, 4).astype(np.float32)
    Y = rng.rand(8, 1).astype(np.float32)
    J.seed(0)
    jnet = cond_net(J)
    state = {k: np.array(v._data) for k, v in jnet.state_dict().items()}
    jl = _train(J, jnet, X, Y)
    lanes = []
    for capture in (False, True):
        monkeypatch.setattr(tdispatch, "capturing",
                            (lambda: True) if capture else (lambda: False))
        net = cond_net(P)
        net.load_state_dict(P.state_dict_from_reference(state, "cpu"))
        lanes.append(_train(P, net, X, Y))
    assert lanes[0] == lanes[1]                 # bitwise
    assert lanes[0][-1] < lanes[0][0]
    np.testing.assert_allclose(lanes[0], jl, rtol=1e-5)
