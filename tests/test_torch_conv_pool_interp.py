"""The port's convolutions, pools and interpolation modes
(``nn/functional/{conv,pooling,common}.py``) against the JAX package's
on the CPU: every case of the op table's A3 part
(``tests/test_torch_op_table.py`` ``OP_CASES``, modules ``a3_conv``,
``a3_pool``, ``a3_interp``) through both packages on the same seeded
NumPy inputs, forward at 1e-5 (the pool indices bitwise, windows of
equal maxima and padded windows among them), the gradient of a seeded
cotangent at 1e-4, and the op names the AMP handler sees. Then the
arguments the JAX package takes and never reads, which raise here."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402

F = P.nn.functional


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", cases_of("a3_conv", "a3_pool",
                                          "a3_interp"), ids=repr)
def test_a3_functional_matches_jax(case):
    check_against_jax(case)


@pytest.mark.parametrize("call", [
    lambda x: F.conv2d_transpose(x, torch.zeros(2, 2, 3, 3),
                                 output_size=[5, 5]),
    lambda x: F.conv1d_transpose(x[0], torch.zeros(2, 2, 3),
                                 output_size=[5]),
    lambda x: F.avg_pool3d(x[None], 2, divisor_override=2),
    lambda x: F.avg_pool2d(x, 2, divisor_override=2),
    lambda x: F.max_pool3d(x[None], 2, return_mask=True),
    lambda x: F.adaptive_max_pool2d(x, 2, return_mask=True),
    lambda x: P.nn.AdaptiveMaxPool1D(2, return_mask=True)(x[0]),
], ids=["conv2d_transpose_output_size", "conv1d_transpose_output_size",
        "avg_pool3d_divisor_override", "avg_pool2d_divisor_override",
        "max_pool3d_return_mask", "adaptive_max_pool2d_return_mask",
        "AdaptiveMaxPool1D_return_mask"])
def test_never_read_arguments_raise(call):
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="never reads"):
        call(x)


def test_max_pool2d_mask_indexes_the_first_maximum_of_a_tied_window():
    x = torch.tensor([[[[1., 1., 0., 2.],
                        [1., 0., 2., 2.]]]])
    out, idx = F.max_pool2d(x, 2, return_mask=True)
    np.testing.assert_array_equal(out.numpy(), [[[[1., 2.]]]])
    np.testing.assert_array_equal(idx.numpy(), [[[[0, 3]]]])
    # a window wholly in the padding holds nothing above -inf: -1
    _, idx = F.max_pool2d(torch.zeros(1, 1, 1, 1), 1, padding=1,
                          return_mask=True)
    assert idx.flatten().tolist() == [-1, -1, -1, -1, 0, -1, -1, -1, -1]
