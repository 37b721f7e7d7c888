"""The slice's two model paths against the JAX package on the CPU, at a
small size: a MobileNetV3-Small (scale 0.35, 32 x 32 images, 10 classes;
``vision/models/mobilenet.py``) and a ViT written from ``nn`` layers
(``tests/test_torch_op_table.py`` ``vit``: 2 blocks, width 64, 4 heads,
patch 8, 10 classes), each built in both packages, the JAX package's
parameters and buffers carried to the port by
``state_dict_from_reference``. Three ``Model.train_batch`` steps (SGD for
the MobileNet, AdamW for the ViT) give losses and parameters within 1e-4
of the JAX package's, and ``predict_batch`` (eval) gives outputs within
1e-5.

The MobileNet's classifier dropout is turned off and its batch norms
take momentum 0 (the running statistics become the last batch's, so
eval normalises as training did) on the layer objects of both packages.
Its three steps are held in float64 in both packages (``jax_enable_x64``
around the JAX side, restored after), as ``test_torch_resnet.py`` holds
ResNet's: at 32 x 32 its last stages normalise 8 values a channel, and
float32 rounding parts the two packages' parameters by 3.7e-4 at step 3
where float64 parts them by 4e-13; its eval is also held in float32,
after one training-mode forward. The ViT's ``k_proj.bias`` has a
gradient that is zero but for rounding (softmax ignores a score shift
shared by all keys), so AdamW moves it by a rounding-driven fraction of
the learning rate, differently in each package: it is held to that
bound, not to the JAX package's values. The JAX package's random
initializers draw from NumPy here (the same distributions), which spares
the test a compile for every parameter shape. Then the MobileNet
forwards of ``tests/test_vision.py:65-80`` and the constructors'
``pretrained=True``, which raises. MobileNetV1, V2 and V3-Large are held
in ``tests/test_torch_mobilenet_family.py``, with these helpers."""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu.nn.initializer as jinit  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_op_table import _np_of, vit  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture
def numpy_reference_init(monkeypatch):
    """The JAX package's initializers draw from a seeded NumPy generator
    (module docstring)."""
    rng = np.random.default_rng(0)

    def uniform(key, shape, dtype, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape, dtype):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    def truncated_normal(key, lower, upper, shape, dtype):
        z = rng.standard_normal(shape)
        while np.any(bad := (z < lower) | (z > upper)):
            z[bad] = rng.standard_normal(int(bad.sum()))
        return jnp.asarray(z, dtype)
    monkeypatch.setattr(jinit, "jax", types.SimpleNamespace(
        random=types.SimpleNamespace(uniform=uniform, normal=normal,
                                     truncated_normal=truncated_normal)))


@contextlib.contextmanager
def _jax_float64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _carry(jnet, tnet):
    state = {k: _np_of(v) for k, v in jnet.state_dict().items()}
    assert tnet.set_state_dict(P.state_dict_from_reference(
        state, "cpu")) == ([], [])


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _models(jnet, tnet, jopt, topt):
    jm, tm = J.Model(jnet), P.Model(tnet, device="cpu")
    jm.prepare(jopt, J.nn.CrossEntropyLoss())
    tm.prepare(topt, P.nn.CrossEntropyLoss())
    return jm, tm


def _train(jm, tm, x, y, steps, lr):
    """``steps`` train_batch calls in both: losses, then every parameter
    and buffer, within 1e-4 (``k_proj.bias`` within its bound)."""
    for _ in range(steps):
        _close(np.float64(tm.train_batch([x], [y])[0]),
               np.float64(jm.train_batch([x], [y])[0]), 1e-4)
    jsd = {k: _np_of(v) for k, v in jm.network.state_dict().items()}
    for k, v in tm.network.state_dict().items():
        if k.endswith("k_proj.bias"):
            for a in (_np_of(v), jsd[k]):
                assert np.abs(a).max() <= 1.05 * lr * steps, k
            continue
        _close(_np_of(v), jsd[k], 1e-4)


def _mobilenets(ctor="mobilenet_v3_small", scale=0.35):
    jnet = getattr(J.vision.models, ctor)(scale=scale, num_classes=10)
    tnet = getattr(P.vision.models, ctor)(scale=scale, num_classes=10,
                                          device="cpu")
    _carry(jnet, tnet)
    for net in (jnet, tnet):
        for layer in net.sublayers():
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0
            elif type(layer).__name__ == "BatchNorm2D":
                layer._momentum = 0.0
    return jnet, tnet


def _sgd(jnet, tnet, lr=0.1):
    return (J.optimizer.SGD(learning_rate=lr, parameters=jnet.parameters()),
            P.optimizer.SGD(learning_rate=lr, parameters=tnet.parameters(),
                            device="cpu"))


def _batch(seed, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 32, 32)).astype(dtype),
            rng.integers(0, 10, (n,)).astype(np.int64))


def _predicts_as_the_reference(jnet, tnet, dtype=np.float32):
    """One training-mode forward (the batch norms keep its statistics),
    then ``predict_batch`` in eval, each within 1e-5 of the JAX
    package's."""
    jm, tm = _models(jnet, tnet, *_sgd(jnet, tnet))
    x, y = _batch(0, 8, dtype)
    _close(np.float64(tm.train_batch([x], [y], update=False)[0]),
           np.float64(jm.train_batch([x], [y], update=False)[0]), 1e-5)
    jnet.eval(), tnet.eval()
    ref = np.asarray(jm.predict_batch([x])[0])
    assert np.abs(ref).max() > 0.1      # normalised: not vanishing
    _close(np.asarray(tm.predict_batch([x])[0]), ref, 1e-5)


def _trains_as_the_reference(jnet, tnet):
    """Three SGD steps in float64, then ``predict_batch`` in eval."""
    with _jax_float64():
        jnet.astype("float64")
        tnet.astype("float64")
        jm, tm = _models(jnet, tnet, *_sgd(jnet, tnet))
        x, y = _batch(0, 8, np.float64)
        _train(jm, tm, x, y, 3, 0.1)
        jnet.eval(), tnet.eval()
        _close(np.asarray(tm.predict_batch([x])[0]),
               np.asarray(jm.predict_batch([x])[0]), 1e-5)


def test_mobilenet_v3_small_predicts_as_the_reference(numpy_reference_init):
    _predicts_as_the_reference(*_mobilenets())


def test_mobilenet_v3_small_trains_as_the_reference(numpy_reference_init):
    _trains_as_the_reference(*_mobilenets())


def test_vit_from_nn_layers_trains_and_predicts_as_the_reference(
        numpy_reference_init):
    kw = dict(image=32, patch=8, width=64, depth=2, heads=4, classes=10)
    jnet, tnet = vit(J, **kw), vit(P, **kw)
    _carry(jnet, tnet)
    x, y = _batch(1, 4)
    jnet.eval(), tnet.eval()
    _close(tnet(P.to_tensor(x)).numpy(), jnet(J.to_tensor(x)).numpy(), 1e-5)
    jnet.train(), tnet.train()
    jm, tm = _models(
        jnet, tnet,
        J.optimizer.AdamW(learning_rate=1e-3, parameters=jnet.parameters(),
                          weight_decay=0.05),
        P.optimizer.AdamW(learning_rate=1e-3, parameters=tnet.parameters(),
                          weight_decay=0.05, device="cpu"))
    _train(jm, tm, x, y, 3, 1e-3)
    jnet.eval(), tnet.eval()
    got = np.asarray(tm.predict_batch([x])[0])
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    _close(got, np.asarray(jm.predict_batch([x])[0]), 1e-5)


@pytest.mark.parametrize("ctor,size", [("mobilenet_v1", 64),
                                       ("mobilenet_v2", 64),
                                       ("mobilenet_v3_large", 64),
                                       ("mobilenet_v3_small", 96)])
def test_mobilenet_forward_shapes(ctor, size):
    """``tests/test_vision.py:65-80`` on the port (eval, 4 classes), and
    ``pretrained=True`` raising as the JAX package's does."""
    build = getattr(P.vision.models, ctor)
    net = build(num_classes=4, scale=0.5, device="cpu").eval()
    x = P.to_tensor(np.random.default_rng(2).random(
        (1, 3, size, size), dtype=np.float32))
    assert net(x).shape == [1, 4]
    with pytest.raises(RuntimeError, match="network"):
        build(pretrained=True)
