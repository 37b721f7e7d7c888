"""The port's recurrent layers (``nn/rnn.py``) against the JAX package's
on the CPU: every case of ``RNN_CASES`` (``tests/test_torch_a9_table.py``:
each cell, ``RNN`` over each kind and a custom cell, the stacked layers
and ``BiRNN``, ``sequence_length`` forward, reverse and bidirectional,
``time_major``, initial states) built in both packages with the JAX
package's weights carried by ``state_dict_from_reference``, outputs and
final states at 1e-5 and the gradients of a seeded cotangent (inputs and
every parameter) at 1e-4; the parameter names and the initialisers'
bounds; a 2-layer LSTM language model at width 32 trained 3
``Model.train_batch`` steps against the JAX package's loss curve; and the
op names and output types under O1 bfloat16.

The JAX package's ``nn.SimpleRNN`` cannot be built: its stacked layer
passes the attributes positionally into ``SimpleRNNCell``'s
``activation`` slot (``paddle_tpu/nn/rnn.py:295``) and raises
``TypeError``. The port builds its cells by keyword; the comparison
builds the JAX package's stack with a cell class that takes the
attributes by position (:func:`_reference_simple_rnn`, a monkeypatch of
the test's own), and :func:`test_reference_simple_rnn_cannot_be_built`
keeps the fault in view."""
import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu.amp as jamp  # noqa: E402
from paddle_tpu.nn import rnn as jrnn  # noqa: E402
from paddle_tpu.ops import dispatch as jdispatch  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_a9_table import RNN_CASES, lstm_lm  # noqa: E402
from test_torch_op_table import (_np_of,  # noqa: E402
                                 assert_layer_case_close, run_layer_case)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0], dict(tamp._STATE), dict(jamp._STATE)
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved[0]
    tamp._STATE.update(saved[1])
    jamp._STATE.update(saved[2])


class _PositionalCell(jrnn.SimpleRNNCell):
    """The JAX package's cell, taking the attributes where its stacked
    layer passes them."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 activation="tanh"):
        super().__init__(input_size, hidden_size, activation, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


@pytest.fixture
def _reference_simple_rnn(monkeypatch):
    monkeypatch.setattr(jrnn, "SimpleRNNCell", _PositionalCell)


def test_reference_simple_rnn_cannot_be_built():
    with pytest.raises(TypeError, match="activation"):
        J.nn.SimpleRNN(4, 6)
    assert P.nn.SimpleRNN(4, 6, activation="relu", device="cpu"
                          ).cell_0_0.activation == "relu"


def _ref_state(layer):
    return {k: _np_of(v) for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("case", RNN_CASES, ids=repr)
def test_rnn_layer_matches_jax(case, _reference_simple_rnn):
    J.seed(7)
    ref_state = _ref_state(case.build(J))
    ref = run_layer_case(J, case, state=ref_state)
    got = run_layer_case(P, case, state=P.state_dict_from_reference(
        ref_state, device="cpu"))
    assert_layer_case_close(case, got, ref, "port vs JAX")


@pytest.mark.parametrize("kind,gates", [("SimpleRNN", 1), ("LSTM", 4),
                                        ("GRU", 3)])
def test_names_shapes_and_initialiser_bounds_match_the_reference(
        kind, gates, _reference_simple_rnn):
    """``cell_{layer}_{direction}.{weight,bias}_{ih,hh}`` with the
    reference's shapes, every value within ``1/sqrt(hidden)``."""
    hid = 16
    J.seed(3)
    ref = getattr(J.nn, kind)(8, hid, num_layers=2, direction="bidirect")
    P.seed(3)
    got = getattr(P.nn, kind)(8, hid, num_layers=2, direction="bidirect")
    rs, gs = ref.state_dict(), got.state_dict()
    assert list(gs) == list(rs)
    for k in rs:
        assert tuple(gs[k].shape) == tuple(rs[k].shape), k
        assert float(gs[k].abs().max()) <= 1 / np.sqrt(hid)
    assert tuple(gs["cell_1_0.weight_ih"].shape) == (gates * hid, 2 * hid)


def _lm_pair(dropout=0.0):
    """The LSTM LM at width 32 in both packages, the port's with the JAX
    package's weights."""
    J.seed(11)
    jnet, jloss = lstm_lm(J, vocab=50, hidden=32, layers=2, dropout=dropout,
                          init_scale=0.1)
    pnet, ploss = lstm_lm(P, vocab=50, hidden=32, layers=2, dropout=dropout,
                          init_scale=0.1)
    pnet.set_state_dict(P.state_dict_from_reference(_ref_state(jnet),
                                                    device="cpu"))
    return (jnet, jloss), (pnet, ploss)


def _lm_batch():
    ids = np.random.default_rng(27).integers(0, 50, (4, 9))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def test_lstm_lm_train_batch_curve_matches_jax():
    """3 ``train_batch`` steps of SGD(1.0) with ``ClipGradByGlobalNorm(
    10)``, dropout 0, on one batch: each step's loss at 1e-4."""
    (jnet, jloss), (pnet, ploss) = _lm_pair()
    jm = J.Model(jnet)
    jm.prepare(J.optimizer.SGD(learning_rate=1.0,
                               parameters=jnet.parameters(),
                               grad_clip=J.nn.ClipGradByGlobalNorm(10.0)),
               jloss)
    pm = P.Model(pnet, device="cpu")
    pm.prepare(P.optimizer.SGD(learning_rate=1.0,
                               parameters=pnet.parameters(), device="cpu",
                               grad_clip=P.nn.ClipGradByGlobalNorm(10.0)),
               ploss)
    x, y = _lm_batch()
    got, ref = [], []
    for _ in range(3):
        ref.append(float(np.asarray(jm.train_batch([x], [y])[0])))
        got.append(float(np.asarray(pm.train_batch([x], [y])[0])))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[2] < got[0]


@contextlib.contextmanager
def _recording(m, seen):
    """Record the op names package ``m``'s AMP handler sees with a tensor
    among the arguments, in place of the handler (nothing is cast)."""
    if m is J:
        prev = jdispatch._AMP_HANDLER[0]

        def rec(name, tensors):
            seen.append(name)
            return tensors
        jdispatch._AMP_HANDLER[0] = rec
    else:
        prev = tdispatch._AMP_HANDLER[0]

        def rec(name, args):
            if any(isinstance(a, torch.Tensor) for a in args):
                seen.append(name)
            return args
        tdispatch.register_amp_handler(rec)
    try:
        yield
    finally:
        if m is J:
            jdispatch._AMP_HANDLER[0] = prev
        else:
            tdispatch.register_amp_handler(prev)


def test_o1_op_names_and_types_match_jax():
    """The LM's forward under O1 bfloat16: the ops the AMP handler sees
    (one ``rnn_scan_lstm`` a layer), the outputs' types (the linear head
    in bfloat16) and the loss at 2e-2 of the JAX package's."""
    (jnet, jloss), (pnet, ploss) = _lm_pair()
    x, y = _lm_batch()
    out = {}
    for m, net, loss in ((J, jnet, jloss), (P, pnet, ploss)):
        seen = []
        with _recording(m, seen), m.amp.auto_cast(level="O1",
                                                  dtype="bfloat16"):
            loss(net(m.to_tensor(x)), m.to_tensor(y))
        with m.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = net(m.to_tensor(x))
            val = loss(logits, m.to_tensor(y))
        out[m] = (seen, str(logits.dtype).split(".")[-1],
                  float(np.asarray(_np_of(val))))
    (js, jdt, jv), (ps, pdt, pv) = out[J], out[P]
    assert ps == js
    assert ps.count("rnn_scan_lstm") == 2
    assert pdt == jdt == "bfloat16"
    np.testing.assert_allclose(pv, jv, rtol=2e-2)


def test_lstm_dropout_between_layers_draws_in_training_only():
    """``dropout`` acts between the stacked layers in training (two draws
    differ) and not in eval (two calls equal)."""
    P.seed(5)
    net = P.nn.LSTM(4, 6, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 4)).astype(np.float32))
    net.train()
    a, b = net(x)[0], net(x)[0]
    assert not torch.equal(a, b)
    net.eval()
    assert torch.equal(net(x)[0], net(x)[0])


def test_rows_past_their_length_freeze_and_emit_zeros():
    """Reverse direction with lengths: outputs past a row's length are 0,
    its final state the state after its last valid step, and a
    bidirectional LSTM's row of length n equals the same row cut to n."""
    P.seed(9)
    net = P.nn.LSTM(4, 6, direction="bidirect", device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 5, 4)).astype(np.float32))
    lens = torch.tensor([5, 2])
    y, (h, c) = net(x, sequence_length=lens)
    assert torch.all(y[1, 2:] == 0)
    y1, (h1, c1) = net(x[1:, :2])
    torch.testing.assert_close(y[1:, :2], y1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h[:, 1:], h1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(c[:, 1:], c1, rtol=1e-6, atol=1e-6)


def test_rnn_names_in_the_reference_namespaces():
    import paddle_tpu.nn.rnn as jrnn_mod
    from paddle_tpu_torch.nn import rnn as trnn
    names = [n for n in dir(jrnn_mod) if not n.startswith("_")
             and isinstance(getattr(jrnn_mod, n), type)
             and getattr(jrnn_mod, n).__module__ == jrnn_mod.__name__]
    assert sorted(names) == sorted(trnn.__all__)
    for n in names:
        assert getattr(P.nn, n) is getattr(trnn, n), n
