"""The rest of ``vision/models/mobilenet.py`` against the JAX package on
the CPU, as ``tests/test_torch_mobilenet_vit.py`` holds MobileNetV3-Small
(its helpers; scale 0.25, 32 x 32 images, 10 classes, the JAX package's
parameters and buffers carried by ``state_dict_from_reference``):
MobileNetV1's depthwise-separable blocks and MobileNetV2's inverted
residuals in one training-mode forward and ``predict_batch`` within
1e-5, and MobileNetV3-Large in three SGD steps within 1e-4 and its eval
predict within 1e-5.

All three are held in float64 in both packages. In float32, rounding
alone parts the two packages' V1 and V2 outputs by up to 1.3e-4 (of 2.5)
at 32 x 32 and 7e-5 (of 2.2) at 64 x 64, where float64 parts them by
6e-13: the last stages normalise a few values a channel, and the
float32 losses lie on either side of the float64 one."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_mobilenet_vit import (  # noqa: E402,F401
    _jax_float64, _mobilenets, _predicts_as_the_reference,
    _trains_as_the_reference, numpy_reference_init)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("ctor", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_v1_v2_predict_as_the_reference(numpy_reference_init,
                                                  ctor):
    jnet, tnet = _mobilenets(ctor, 0.25)
    with _jax_float64():
        jnet.astype("float64")
        tnet.astype("float64")
        _predicts_as_the_reference(jnet, tnet, np.float64)


def test_mobilenet_v3_large_trains_as_the_reference(numpy_reference_init):
    """The model the card trains and serves at full width."""
    _trains_as_the_reference(*_mobilenets("mobilenet_v3_large", 0.25))
