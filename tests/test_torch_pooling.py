"""The ops ResNet, VGG, LeNet and BERT add to the port (``relu``,
``tanh``, max, average and adaptive-average pooling, ``Flatten`` and
``CrossEntropyLoss``) against the JAX package on the same numpy inputs:
forward and the input's gradient (of ``sum(out * g)``, ``g`` random)
within 1e-6, for every padding form of ``_pool_nd`` (int, pair, per-side
pads, ``"SAME"``, ``"VALID"``), ``ceil_mode`` (a window wholly in the
padding included), ``exclusive``, NHWC, non-uniform adaptive bins, and
the ReLU-then-max-pool case whose windows are all zeros (the gradient
must reach the same element of each tie)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.manipulation import flatten  # noqa: E402

TOL = 1e-6


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _both(jfn, tfn, x, seed=0, grad=True):
    """``jfn`` on the JAX side and ``tfn`` on the port's, on the same
    ``x``: (JAX out, port out, JAX dx, port dx)."""
    jx = paddle.to_tensor(x, stop_gradient=not grad)
    tx = torch.from_numpy(x.copy()).requires_grad_(grad)
    jy, ty = jfn(jx), tfn(tx)
    assert tuple(ty.shape) == tuple(jy.shape)
    if not grad:
        return _np(jy), ty.detach().numpy(), None, None
    g = np.random.default_rng(seed + 100).standard_normal(
        tuple(ty.shape)).astype(np.float32)
    (jy * paddle.to_tensor(g)).sum().backward()
    (ty * torch.from_numpy(g)).sum().backward()
    return _np(jy), ty.detach().numpy(), _np(jx.grad), tx.grad.numpy()


def _close(jy, ty, jg=None, tg=None, tol=TOL):
    np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    if jg is not None:
        np.testing.assert_allclose(tg, jg, rtol=tol, atol=tol)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- activations --------------------------------------------------------------

@pytest.mark.parametrize("name", ["relu", "tanh"])
def test_activation_matches_jax(name):
    x = _x((3, 4, 5))
    x[0, 0, :2] = 0.0                     # relu's kink: both give 0 there
    _close(*_both(getattr(JF, name), getattr(F, name), x))
    jl, tl = getattr(jnn, name.capitalize().replace("Relu", "ReLU"))(), \
        getattr(tnn, name.capitalize().replace("Relu", "ReLU"))()
    _close(*_both(jl, tl, x))


# -- max and average pooling --------------------------------------------------

# (kernel, stride, padding, ceil_mode): every padding form, windows that
# the ceil pad widens, and the (5, k 2, s 3, p 1) shape whose last ceil
# window lies wholly in the padding
POOL_CASES = {
    "k3_s2_p1": (3, 2, 1, False),
    "k2_s2_p0": (2, 2, 0, False),
    "k3_s1_pair": (3, 1, [1, 0], False),
    "k3_s2_per_side": (3, 2, [0, 1, 1, 2], False),
    "k3_s2_same": (3, 2, "SAME", False),
    "k2_s1_same": (2, 1, "same", False),
    "k3_s2_valid": (3, 2, "VALID", False),
    "k3_s2_p1_ceil": (3, 2, 1, True),
    "k2_s2_ceil": (2, 2, 0, True),
    "k2_s3_p1_ceil": (2, 3, 1, True),
    "kpair_spair": ([3, 2], [2, 1], [1, 0], False),
    "k3_s2_p2": (3, 2, 2, False),
}
SHAPE = (2, 3, 9, 10)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_max_pool2d_matches_jax(case):
    k, s, p, ceil = POOL_CASES[case]
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil)
    x = _x(SHAPE, 1) if case != "k2_s3_p1_ceil" else _x((2, 3, 5, 5), 1)
    _close(*_both(lambda a: JF.max_pool2d(a, **kw),
                  lambda a: F.max_pool2d(a, **kw), x))


# a window wholly in the padding holds no element to average (0/0 in
# both packages): that shape is held inclusive only, and by max pooling
AVG_CASES = [(c, e) for c in POOL_CASES for e in (True, False)
             if not (c == "k2_s3_p1_ceil" and e)]


@pytest.mark.parametrize("case,exclusive", AVG_CASES,
                         ids=[f"{c}-{'exclusive' if e else 'inclusive'}"
                              for c, e in AVG_CASES])
def test_avg_pool2d_matches_jax(case, exclusive):
    k, s, p, ceil = POOL_CASES[case]
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil,
              exclusive=exclusive)
    x = _x(SHAPE, 2) if case != "k2_s3_p1_ceil" else _x((2, 3, 5, 5), 2)
    _close(*_both(lambda a: JF.avg_pool2d(a, **kw),
                  lambda a: F.avg_pool2d(a, **kw), x))


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_nhwc_matches_jax(kind):
    x = _x((2, 9, 10, 3), 3)
    jfn = getattr(JF, f"{kind}_pool2d")
    tfn = getattr(F, f"{kind}_pool2d")
    kw = dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2],
              data_format="NHWC")
    _close(*_both(lambda a: jfn(a, **kw), lambda a: tfn(a, **kw), x))


@pytest.mark.parametrize("case", ["k3_s2_p1", "k3_s2_per_side",
                                  "k2_s2_ceil", "k3_s2_same"])
def test_pool1d_matches_jax(case):
    k, s, p, ceil = POOL_CASES[case]
    if isinstance(p, list):
        p = p[:2]
    x = _x((2, 3, 11), 4)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil)
    _close(*_both(lambda a: JF.max_pool1d(a, **kw),
                  lambda a: F.max_pool1d(a, **kw), x))
    for exclusive in (True, False):
        _close(*_both(lambda a: JF.avg_pool1d(a, exclusive=exclusive, **kw),
                      lambda a: F.avg_pool1d(a, exclusive=exclusive, **kw),
                      x))


def test_relu_then_max_pool_ties_send_the_gradient_where_jax_does():
    """ResNet's stem: ReLU, then a 3x3 stride-2 max pool padded by 1.
    Mostly negative inputs make whole windows of zeros; the gradient of
    each tie must land on the same element in both packages."""
    x = _x((2, 4, 12, 12), 5) - 1.5
    x[0, 0, 3, 3] = 0.0                   # an exact zero among the ties
    jy, ty, jg, tg = _both(lambda a: JF.max_pool2d(JF.relu(a), 3, 2, 1),
                           lambda a: F.max_pool2d(F.relu(a), 3, 2, 1), x)
    assert (ty == 0).mean() > 0.3         # many all-zero windows
    np.testing.assert_array_equal(ty, jy)
    # ReLU passes no gradient below zero, so place the tie's gradient
    # before the ReLU: only where the max pool picked it
    jx = paddle.to_tensor(np.maximum(x, 0), stop_gradient=False)
    tx = torch.from_numpy(np.maximum(x, 0)).requires_grad_()
    g = np.random.default_rng(9).standard_normal(ty.shape).astype(
        np.float32)
    (JF.max_pool2d(jx, 3, 2, 1) * paddle.to_tensor(g)).sum().backward()
    (F.max_pool2d(tx, 3, 2, 1) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("out", [(4, 5), (1, 1), (4, 3), (3, 3), (7, 7)],
                         ids=["uniform", "global", "nonuniform_4x3",
                              "nonuniform_3x3", "upsampling_7x7"])
def test_adaptive_avg_pool2d_matches_jax(out):
    x = _x((2, 3, 8, 10) if out in ((4, 5), (1, 1)) else (2, 3, 9, 10), 6)
    _close(*_both(lambda a: JF.adaptive_avg_pool2d(a, out),
                  lambda a: F.adaptive_avg_pool2d(a, out), x))
    _close(*_both(jnn.AdaptiveAvgPool2D(out), tnn.AdaptiveAvgPool2D(out), x))


def test_adaptive_avg_pool_nhwc_and_1d_match_jax():
    x = _x((2, 9, 10, 3), 7)
    _close(*_both(
        lambda a: JF.adaptive_avg_pool2d(a, (4, 3), data_format="NHWC"),
        lambda a: F.adaptive_avg_pool2d(a, (4, 3), data_format="NHWC"), x))
    x1 = _x((2, 3, 11), 8)
    for size in (4, 11, 1):
        _close(*_both(lambda a: JF.adaptive_avg_pool1d(a, size),
                      lambda a: F.adaptive_avg_pool1d(a, size), x1))
        _close(*_both(jnn.AdaptiveAvgPool1D(size),
                      tnn.AdaptiveAvgPool1D(size), x1))


@pytest.mark.parametrize("layer,args", [
    ("MaxPool2D", (3, 2, 1)), ("MaxPool2D", (2, 2, 0, False, True)),
    ("AvgPool2D", (3, 2, 1)), ("AvgPool2D", (3, 2, 1, True, False)),
    ("MaxPool1D", (3, 2, 1)), ("AvgPool1D", (3, 2, 1, False))],
    ids=["max", "max_ceil", "avg", "avg_ceil_inclusive", "max1d",
         "avg1d_inclusive"])
def test_pool_layers_match_jax(layer, args):
    x = _x((2, 3, 9, 10) if "2D" in layer else (2, 3, 11), 9)
    _close(*_both(getattr(jnn, layer)(*args), getattr(tnn, layer)(*args), x))


def test_unported_pool_options_raise():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="A3"):
        F.max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="A3"):
        F.avg_pool2d(x, 2, divisor_override=3)


# -- Flatten and CrossEntropyLoss ---------------------------------------------

@pytest.mark.parametrize("start,stop", [(1, -1), (0, -1), (1, 2), (-2, -1),
                                        (2, 2)])
def test_flatten_matches_jax(start, stop):
    x = _x((2, 3, 4, 5), 10)
    _close(*_both(lambda a: jops.flatten(a, start, stop),
                  lambda a: flatten(a, start, stop), x))
    _close(*_both(jnn.Flatten(start, stop), tnn.Flatten(start, stop), x))


CE_CASES = {
    "mean": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "weight": dict(weight=True),
    "ignore_index": dict(ignore_index=3),
    "soft_label": dict(soft_label=True),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_loss_matches_jax(case):
    """``CrossEntropyLoss`` on ``[B, C]`` logits and ``[B]`` int64 labels
    (bench.py's ResNet-50 batch), forward and the logits' gradient."""
    kw = dict(CE_CASES[case])
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((8, 10)) * 3).astype(np.float32)
    if kw.get("soft_label"):
        lab = rng.random((8, 10)).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.integers(0, 10, (8,)).astype(np.int64)
        lab[:2] = 3
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("weight", None):
        w = rng.uniform(0.5, 2.0, 10).astype(np.float32)
        jkw["weight"], tkw["weight"] = paddle.to_tensor(w), \
            torch.from_numpy(w)
    jl, tl = jnn.CrossEntropyLoss(**jkw), tnn.CrossEntropyLoss(**tkw)
    _close(*_both(lambda a: jl(a, paddle.to_tensor(lab)),
                  lambda a: tl(a, torch.from_numpy(lab)), logits))
