"""The port's activations (``nn/functional/activation.py``) against the
JAX package's on the CPU: every case of the op table's activation part
(``tests/test_torch_op_table.py`` ``OP_CASES``) through both packages on the
same seeded NumPy inputs, forward at 1e-5 and the gradient of a seeded
cotangent at 1e-4. The random lanes (``rrelu`` in training,
``gumbel_softmax``) are held by determinism under ``seed`` and their
moments in ``test_torch_ops_creation_linalg.py``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", cases_of("activation"), ids=repr)
def test_functional_matches_jax(case):
    check_against_jax(case)


def test_maxout_on_a_negative_axis_matches_numpy():
    """The JAX package's maxout misplaces a negative axis, so the port's
    is held against NumPy: the max over each group of channels."""
    x = np.random.default_rng(4).standard_normal((2, 6)).astype(np.float32)
    t = P.to_tensor(x, stop_gradient=False)
    out = P.nn.functional.maxout(t, 3, axis=-1)
    np.testing.assert_array_equal(out.numpy(), x.reshape(2, 2, 3).max(-1))
    out.sum().backward()
    assert t.grad.numpy().sum() == 4.0
