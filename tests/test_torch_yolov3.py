"""YOLOv3-DarkNet53: the port against the JAX package at the tiny size
of ``tests/test_yolov3_e2e.py`` (width 0.125, 4 classes, 64x64), weights
carried through a ``paddle.save`` file. Head outputs within 1e-4 of
each output's largest |value|; ``decode`` fed the same head outputs
gives equal labels and counts, and scores and boxes at rtol 1e-5. The
layers and the full-width state dict are in
``test_torch_vision_layers.py``."""
import os
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.vision.models import YOLOv3 as JYOLOv3  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.vision.models import (YOLOv3,  # noqa: E402
                                            darknet53, yolov3_darknet53)

TOL = 1e-5
TINY = dict(num_classes=4, width_mult=0.125)    # tests/test_yolov3_e2e.py


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _jax_tiny(seed=7):
    """The tiny detector with running statistics that are not the
    identity, so eval-mode BatchNorm does real work."""
    paddle.seed(seed)
    jm = JYOLOv3(**TINY)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jm.state_dict().items():
        a = np.asarray(v.numpy())
        if k.endswith("._mean"):
            a = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        elif k.endswith("._variance"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        sd[k] = a
    jm.set_state_dict(sd)
    jm.eval()
    return jm


@pytest.fixture(scope="module")
def tiny():
    """Both detectors with the same weights, 3 images and the JAX
    package's head outputs on them."""
    jm = _jax_tiny()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "yolov3.pdparams")
        paddle.save(jm.state_dict(), path)
        tm = YOLOv3(**TINY, device="cpu", seed=3)
        tm.load_state_dict(framework_io.load(path), strict=True)
    x = np.random.default_rng(0).random((3, 3, 64, 64), dtype=np.float32)
    ref = [np.array(_np(o)) for o in jm(paddle.to_tensor(x))]
    return jm, tm.eval(), x, ref


def test_head_outputs_match_jax(tiny):
    _, tm, x, ref = tiny
    with torch.no_grad():
        got = [o.numpy() for o in tm(torch.from_numpy(x))]
    assert [g.shape for g in got] == [(3, 27, 2, 2), (3, 27, 4, 4),
                                      (3, 27, 8, 8)]
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def test_decode_of_the_same_head_outputs_matches_jax(tiny):
    """The JAX package's defaults (conf 0.01, NMS 0.45, nms_top_k 400,
    keep_top_k 100); other settings are in test_torch_detection.py."""
    jm, tm, _, outs = tiny
    img = np.array([[64, 64], [48, 64], [64, 30]], np.int32)
    jd, jc = jm.decode([paddle.to_tensor(o) for o in outs],
                       paddle.to_tensor(img))
    td, tc = tm.decode([torch.from_numpy(o) for o in outs],
                       torch.from_numpy(img))
    jd, jc = _np(jd), _np(jc)
    assert tc.dtype == torch.int32 and td.shape == jd.shape == (3, 100, 6)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(td.numpy()[..., 0], jd[..., 0])
    np.testing.assert_allclose(td.numpy()[..., 1:], jd[..., 1:], rtol=TOL,
                               atol=1e-4)
    assert (tc.numpy() > 0).all()


def test_pretrained_raises():
    with pytest.raises(ValueError, match="no bundled weights"):
        yolov3_darknet53(pretrained=True, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: YOLOv3(**TINY), lambda: darknet53(width_mult=0.125),
                 lambda: tnn.Conv2D(3, 4, 3), lambda: tnn.BatchNorm2D(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
