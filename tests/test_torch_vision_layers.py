"""The layers YOLOv3-DarkNet53 is built from (``conv2d``, ``batch_norm``,
``leaky_relu``, nearest ``interpolate``; ``Conv2D``, ``BatchNorm2D``,
``Sequential``) against the JAX package on the same numpy inputs at
1e-5, and the detector's state dict at full width, names and shapes
equal to the JAX package's."""
import collections

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision.models import YOLOv3 as JYOLOv3  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.vision.models import (darknet53,  # noqa: E402
                                            yolov3_darknet53)

TOL = 1e-5


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("padding,stride,bias", [
    (0, 1, True), (1, 2, True), ([1, 2], 1, False), ([0, 1, 2, 1], 1, True),
    ("SAME", 2, False), ("SAME", 1, True), ("VALID", 2, True)],
    ids=["int0", "int1_s2", "per_dim", "per_side", "same_s2", "same",
         "valid_s2"])
def test_conv2d_matches_jax(padding, stride, bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 9, 10)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                    paddle.to_tensor(b) if bias else None, stride=stride,
                    padding=padding)
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b) if bias else None, stride=stride,
                   padding=padding)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


def test_conv2d_groups_dilation_nhwc_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 11, 11)).astype(np.float32)
    w = rng.standard_normal((4, 4, 3, 3)).astype(np.float32)
    kw = dict(stride=1, padding=2, dilation=2, groups=2)
    ref = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), **kw)
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kw)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = JF.conv2d(paddle.to_tensor(xh), paddle.to_tensor(w),
                    data_format="NHWC", **kw)
    got = F.conv2d(torch.from_numpy(xh), torch.from_numpy(w),
                   data_format="NHWC", **kw)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


def _bn_inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    mean = rng.standard_normal(5).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    w = rng.standard_normal(5).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    return x, mean, var, w, b


def test_batch_norm_eval_matches_jax():
    x, mean, var, w, b = _bn_inputs()
    ref = JF.batch_norm(*map(paddle.to_tensor, (x, mean, var, w, b)),
                        training=False)
    got = F.batch_norm(*map(torch.from_numpy, (x, mean, var, w, b)),
                       training=False)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)


def test_batch_norm_train_updates_running_stats_as_jax():
    x, mean, var, w, b = _bn_inputs(3)
    jm, jv = paddle.to_tensor(mean), paddle.to_tensor(var)
    ref = JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                        paddle.to_tensor(b), training=True, momentum=0.8)
    tm, tv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    got = F.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                       torch.from_numpy(b), training=True, momentum=0.8)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=TOL, atol=TOL)
    # paddle's convention: biased batch variance, momentum on the old value
    batch_var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(tv.numpy(), 0.8 * var + 0.2 * batch_var,
                               rtol=1e-5)


def test_batch_norm_layer_train_and_eval_match_jax():
    x = _bn_inputs(4)[0]
    paddle.seed(0)
    jl = jnn.BatchNorm2D(5, momentum=0.7)
    tl = tnn.BatchNorm2D(5, momentum=0.7, device="cpu")
    for _ in range(2):
        ref, got = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), _np(ref),
                                   rtol=TOL, atol=TOL)
    jl.eval()
    tl.eval()
    ref, got = jl(paddle.to_tensor(x)), tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tl._variance.numpy(),
                               _np(jl.state_dict()["_variance"]), rtol=TOL)


def test_leaky_relu_matches_jax():
    x = np.random.default_rng(5).standard_normal((4, 7)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, -1e-30]
    ref = JF.leaky_relu(paddle.to_tensor(x), 0.1)
    got = tnn.LeakyReLU(0.1)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=TOL, atol=0)


@pytest.mark.parametrize("kw", [dict(scale_factor=2), dict(size=[7, 5]),
                                dict(size=[3, 9]), dict(scale_factor=1.5)],
                         ids=["x2", "size_up", "size_mixed", "x1.5"])
def test_nearest_interpolate_matches_jax(kw):
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 6)).astype(
        np.float32)
    ref = JF.interpolate(paddle.to_tensor(x), mode="nearest", **kw)
    got = tnn.Upsample(mode="nearest", **kw)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_interpolate_other_modes_raise():
    with pytest.raises(NotImplementedError, match="A9"):
        F.interpolate(torch.zeros(1, 1, 2, 2), scale_factor=2,
                      mode="bilinear")


def _names_shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_layer_state_dicts_match_jax():
    paddle.seed(0)
    pairs = [
        (jnn.Conv2D(4, 8, 3, bias_attr=False),
         tnn.Conv2D(4, 8, 3, bias_attr=False, device="cpu")),
        (jnn.Conv2D(4, 8, [1, 3], stride=2),
         tnn.Conv2D(4, 8, [1, 3], stride=2, device="cpu")),
        (jnn.BatchNorm2D(8), tnn.BatchNorm2D(8, device="cpu")),
        (jnn.Sequential(jnn.Conv2D(3, 4, 1), jnn.BatchNorm2D(4),
                        jnn.LeakyReLU(0.1)),
         tnn.Sequential(tnn.Conv2D(3, 4, 1, device="cpu"),
                        tnn.BatchNorm2D(4, device="cpu"),
                        tnn.LeakyReLU(0.1))),
        (jnn.Sequential(collections.OrderedDict(
            [("a", jnn.BatchNorm2D(2)), ("b", jnn.Conv2D(2, 2, 1))])),
         tnn.Sequential(collections.OrderedDict(
             [("a", tnn.BatchNorm2D(2, device="cpu")),
              ("b", tnn.Conv2D(2, 2, 1, device="cpu"))]))),
    ]
    for jl, tl in pairs:
        assert _names_shapes(tl.state_dict()) == \
            _names_shapes(jl.state_dict())


def test_conv2d_init_is_paddles_uniform():
    gen = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(16, 32, 3, device="cpu")
    conv.reset_parameters(gen)
    lim = np.sqrt(1.0 / (16 * 9))
    for p in (conv.weight, conv.bias):
        assert p.abs().max().item() <= lim
    assert conv.weight.abs().max().item() > 0.99 * lim     # 4608 draws


def test_state_dict_names_match_at_full_width():
    paddle.seed(0)
    jm = JYOLOv3(num_classes=80)
    tm = yolov3_darknet53(num_classes=80, device="cpu")
    assert _names_shapes(tm.state_dict()) == _names_shapes(jm.state_dict())
    assert darknet53(device="cpu").out_channels == [256, 512, 1024]
