"""The port's ``quantization`` package against the JAX package's, on the
same numpy inputs from a seed: ``quantize_weight_int8`` codes and scales
byte for byte, the fake quantizers' values and straight-through
gradients, the moving-average observer after the same batches and its
state dict under both key sets, QAT on a small Linear/Conv2D net (equal
losses at 1e-5), PTQ ``convert`` to real int8 layers whose forwards equal
the JAX ones at 1e-5 in both ``Int8Linear`` lanes and in ``Int8Conv2D``,
the padded ``torch._int_mm`` lane bitwise equal to the exact integer
product at odd shapes, and the weight carry keeping int8 arrays int8."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.optimizer as joptim  # noqa: E402
from paddle_tpu import quantization as jq  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch import quantization as tq  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# -- the functions ------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((8, 4), 1), ((8, 4), 0),
                                        ((6, 3, 3, 3), 0), ((33, 17), 1)])
def test_quantize_weight_int8_byte_equal_jax(shape, axis):
    """Per-channel absmax / 127, round half to even, clip: the same int8
    codes and float32 scales, byte for byte, an all-zero channel (scale
    1/127) and exact halves included."""
    w = _rand(1, *shape)
    w.reshape(shape[0], -1)[:, 0] = 63.5 / 127.0     # ties at scale 1/127
    w = np.moveaxis(w, axis, 0)
    w[1] = 0.0
    w = np.ascontiguousarray(np.moveaxis(w, 0, axis))
    jqv, jsv = jq.quantize_weight_int8(w, quant_axis=axis)
    tqv, tsv = tq.quantize_weight_int8(torch.from_numpy(w), quant_axis=axis)
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    assert _np(tqv).tobytes() == np.asarray(jqv).tobytes()
    assert _np(tsv).tobytes() == np.asarray(jsv).tobytes()
    ref = np.asarray(jq._expand_scale(jsv, w.ndim, axis))
    got = _np(tq._expand_scale(tsv, w.ndim, axis))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantizers_and_their_gradients_equal_jax(bits):
    """Per-tensor and per-channel fake quantization: the same values
    (within an ulp) and scales, and the straight-through gradient of a
    weighted sum equal to the JAX package's (the weights themselves)."""
    x = _rand(2, 6, 5)
    g = _rand(3, 6, 5)
    for fn, kw in (("fake_quantize_abs_max", {}),
                   ("fake_channel_wise_quantize_abs_max",
                    {"quant_axis": 1})):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jout, jscale = getattr(jq, fn)(jx, bits, **kw)
        (jout * paddle.to_tensor(g)).sum().backward()
        tx = torch.from_numpy(x.copy()).requires_grad_()
        tout, tscale = getattr(tq, fn)(tx, bits, **kw)
        (tout * torch.from_numpy(g)).sum().backward()
        # XLA may fold the division by the constant qmax into a product,
        # one rounding apart: the values within 1 ulp, the scales exact
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=2e-7,
                                   atol=0)
        np.testing.assert_array_equal(_np(tscale), _np(jscale))
        np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
        np.testing.assert_array_equal(_np(tx.grad), g)


def test_quant_dequant_with_scale_equals_jax():
    x = _rand(4, 7, 3, scale=2.0)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jq.quant_dequant_with_scale(jx, 1.5)
    jout.sum().backward()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tout = tq.quant_dequant_with_scale(tx, 1.5)
    tout.sum().backward()
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2e-7, atol=0)
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))


def _observed(mod, batches, tensor):
    obs = mod.MovingAverageAbsMaxObserver(moving_rate=0.9)
    for b in batches:
        obs.observe(tensor(b))
    return obs


def test_observer_state_equals_jax_and_round_trips_both_key_sets():
    batches = [_rand(10 + i, 4, 4, scale=1.0 + i) for i in range(4)]
    jo = _observed(jq, batches, paddle.to_tensor)
    to = _observed(tq, batches, torch.from_numpy)
    assert (to.scale, to._accum, to._state) == (jo.scale, jo._accum,
                                                jo._state)
    sd, jsd = to.state_dict(), jo.state_dict()
    assert set(sd) == set(jsd) == {"scale", "accum", "state", "OutScale",
                                   "InAccum", "InState"}
    for k in sd:
        assert sd[k].tobytes() == jsd[k].tobytes()
    for keys in (("scale", "accum", "state"),
                 ("OutScale", "InAccum", "InState")):
        fresh = tq.MovingAverageAbsMaxObserver().set_state_dict(
            {k: sd[k] for k in keys})
        jfresh = jq.MovingAverageAbsMaxObserver().set_state_dict(
            {k: jsd[k] for k in keys})
        assert (fresh.scale, fresh._accum, fresh._state) == (
            jfresh.scale, jfresh._accum, jfresh._state)
    # accum / state alone give the running average
    only = tq.MovingAverageAbsMaxObserver().set_state_dict(
        {"InAccum": sd["InAccum"], "InState": sd["InState"]})
    assert only.scale == pytest.approx(float(sd["InAccum"])
                                       / float(sd["InState"]))


# -- QAT and PTQ --------------------------------------------------------------

class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(2, 3, 3, padding=1)
        self.fc1 = jnn.Linear(3 * 4 * 4, 8)
        self.fc2 = jnn.Linear(8, 2)

    def forward(self, x):
        h = jnn.functional.relu(self.conv(x))
        h = paddle.reshape(h, [h.shape[0], -1])
        return self.fc2(jnn.functional.relu(self.fc1(h)))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = P.nn.Conv2D(2, 3, 3, padding=1, device="cpu")
        self.fc1 = P.nn.Linear(3 * 4 * 4, 8, device="cpu")
        self.fc2 = P.nn.Linear(8, 2, device="cpu")

    def forward(self, x):
        h = P.nn.functional.relu(self.conv(x))
        h = h.reshape(h.shape[0], -1)
        return self.fc2(P.nn.functional.relu(self.fc1(h)))


def _nets():
    paddle.seed(0)
    jnet = _JNet()
    tnet = _TNet()
    tnet.load_state_dict(framework_io.state_dict_from_reference(
        {k: _np(v) for k, v in jnet.state_dict().items()}, "cpu"))
    return jnet, tnet


def _data(n=8):
    return _rand(20, n, 2, 4, 4), _rand(21, n, 2)


def test_qat_trains_a_linear_conv_net_with_the_jax_losses():
    """ImperativeQuantAware swaps both Linears and the Conv2D for their
    wrappers (same state-dict keys as the JAX package's) and five SGD
    steps of the fake-quantized net give the JAX package's losses at
    1e-5, observer scales beside."""
    jnet, tnet = _nets()
    jq.ImperativeQuantAware().quantize(jnet)
    tq.ImperativeQuantAware().quantize(tnet)
    assert isinstance(tnet.fc1, tq.QuantedLinear)
    assert isinstance(tnet.conv, tq.QuantedConv2D)
    # the parameters under the JAX package's keys; the port's nested
    # state dict also carries each wrapper's observer (the JAX package's
    # holds it only in the wrapper's own state dict)
    keys = set(tnet.state_dict())
    assert {k for k in keys if "_observer." not in k} == set(
        jnet.state_dict())
    assert len(keys - set(jnet.state_dict())) == 3 * 6
    jopt = joptim.SGD(learning_rate=0.1, parameters=jnet.parameters())
    topt = P.optimizer.SGD(learning_rate=0.1, parameters=tnet.parameters(),
                           device="cpu")
    x, y = _data()
    jl, tl = [], []
    for _ in range(5):
        loss = ((jnet(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2
                ).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        tloss = ((tnet(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2
                 ).mean()
        tloss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    for name in ("conv", "fc1", "fc2"):
        assert getattr(tnet, name)._observer.scale == pytest.approx(
            jnet._sub_layers[name]._observer.scale, rel=1e-5)


def test_wrapper_state_dict_carries_the_observer():
    """A QuantedLinear's state dict holds the observer's triple under
    ``_observer.`` beside its weight and bias (the JAX package's keys),
    and a fresh wrapper loading it gets the calibrated scale."""
    lin = P.nn.Linear(4, 2, device="cpu")
    lin.reset_parameters()
    q = tq.QuantedLinear(lin)
    for i in range(3):
        q(torch.from_numpy(_rand(30 + i, 8, 4)))
    sd = q.state_dict()
    jq_lin = jq.QuantedLinear(jnn.Linear(4, 2))
    assert set(sd) == set(jq_lin.state_dict())
    fresh = tq.QuantedLinear(P.nn.Linear(4, 2, device="cpu"))
    fresh.set_state_dict(sd)
    assert fresh._observer.scale == pytest.approx(q._observer.scale)
    torch.testing.assert_close(fresh.weight, q.weight, rtol=0, atol=0)


def test_ptq_convert_gives_int8_layers_with_the_jax_forward():
    """PTQ: calibrate on four batches, convert; the Linears become
    Int8Linear (int8 x int8 -> int32 lane, the observer's activation
    scale) and the Conv2D an Int8Conv2D (weight-only), with int8 codes
    and scales byte-equal to the JAX package's and a forward equal at
    1e-5."""
    jnet, tnet = _nets()
    jptq, tptq = jq.ImperativePTQ(), tq.ImperativePTQ()
    jptq.quantize(jnet)
    tptq.quantize(tnet)
    for i in range(4):
        x = _rand(40 + i, 8, 2, 4, 4)
        jnet(paddle.to_tensor(x))
        with torch.no_grad():
            tnet(torch.from_numpy(x))
    jptq.convert(jnet)
    tptq.convert(tnet)
    assert isinstance(tnet.fc1, tq.Int8Linear)
    assert isinstance(tnet.conv, tq.Int8Conv2D)
    for name in ("conv", "fc1", "fc2"):
        t, j = getattr(tnet, name), jnet._sub_layers[name]
        assert t.weight_q.dtype == torch.int8
        assert _np(t.weight_q).tobytes() == _np(j.weight_q).tobytes()
        assert _np(t.w_scale).tobytes() == _np(j.w_scale).tobytes()
        if name != "conv":
            assert t._act_scale == pytest.approx(j._act_scale, rel=1e-6)
        np.testing.assert_allclose(_np(t.weight), _np(j.weight), **TOL)
    x, _ = _data(5)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(jnet(paddle.to_tensor(x))),
                               **TOL)


@pytest.mark.parametrize("act", [None, "calibrated"],
                         ids=["weight_only", "int8_activations"])
def test_int8_linear_lanes_equal_jax(act):
    """Both Int8Linear lanes at a 3-D input: weight-only ``(x @ q) * s``
    and the int8 x int8 lane, at 1e-5 from the JAX package's."""
    w, b = _rand(50, 24, 20), _rand(51, 20)
    x = _rand(52, 3, 5, 24)
    scale = None if act is None else float(np.abs(x).max())
    jl = jq.Int8Linear.from_float(paddle.to_tensor(w),
                                  bias=paddle.to_tensor(b), act_scale=scale)
    tl = tq.Int8Linear.from_float(torch.from_numpy(w),
                                  bias=torch.from_numpy(b), act_scale=scale)
    got = _np(tl(torch.from_numpy(x)))
    np.testing.assert_allclose(got, _np(jl(paddle.to_tensor(x))), **TOL)
    assert got.shape == (3, 5, 20)


def test_int8_conv2d_equals_jax():
    w, b = _rand(60, 4, 3, 3, 3), _rand(61, 4)
    x = _rand(62, 2, 3, 9, 9)
    cfg = {"_stride": 2, "_padding": 1}
    jc = jq.Int8Conv2D.from_float(paddle.to_tensor(w),
                                  bias=paddle.to_tensor(b), **cfg)
    tc = tq.Int8Conv2D.from_float(torch.from_numpy(w),
                                  bias=torch.from_numpy(b), **cfg)
    np.testing.assert_allclose(_np(tc(torch.from_numpy(x))),
                               _np(jc(paddle.to_tensor(x))), **TOL)


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (5, 12, 7), (16, 8, 8),
                                   (17, 16, 8), (33, 100, 130),
                                   (64, 768, 24)])
def test_int8_matmul_padded_lane_is_the_exact_integer_product(m, k, n):
    """``torch._int_mm`` takes more than 16 rows and K, N in multiples of
    8 on the card; the wrapper pads with zero codes and slices back, so
    at every shape the int32 result is the exact product bit for bit
    (extreme codes -127 and 127 included)."""
    rng = np.random.default_rng(m * 1000 + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    a[0, :] = 127
    b[:, 0] = 127
    got = tq.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, (a.long() @ b.long()).to(torch.int32))
    assert torch.equal(got, tq.int8_matmul_plain(a, b))


def test_save_quantized_model_raises_naming_a11():
    with pytest.raises(NotImplementedError, match="A11"):
        tq.ImperativeQuantAware().save_quantized_model(torch.nn.Linear(2, 2),
                                                       "x")


def test_weight_carry_keeps_int8_arrays_int8():
    """``state_dict_from_reference`` keeps an int8 array int8 (bytes
    unchanged), so a JAX Int8Linear's state loads into the port's."""
    jl = jq.Int8Linear.from_float(paddle.to_tensor(_rand(70, 6, 4)))
    arrays = {k: _np(v) for k, v in jl.state_dict().items()}
    assert arrays["weight_q"].dtype == np.int8
    carried = framework_io.state_dict_from_reference(arrays, "cpu")
    assert carried["weight_q"].dtype == torch.int8
    assert _np(carried["weight_q"]).tobytes() == arrays["weight_q"].tobytes()
    tl = tq.Int8Linear(torch.zeros((6, 4), dtype=torch.int8), torch.ones(4))
    tl.load_state_dict(carried)
    x = _rand(72, 3, 6)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(paddle.to_tensor(x))), **TOL)
