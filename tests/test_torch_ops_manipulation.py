"""The port's shape and layout ops (``paddle_tpu_torch/ops/manipulation.py``)
against the JAX package's on the CPU: every case of the op table's
manipulation part (``tests/test_torch_op_table.py`` ``OP_CASES``), forward at
1e-5 and the gradient of a seeded cotangent at 1e-4, plus
``broadcast_shape`` and ``tolist``, which take no tensor op."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", cases_of("manipulation"), ids=repr)
def test_manipulation_op_matches_jax(case):
    check_against_jax(case)


def test_broadcast_shape_and_tolist():
    for m in (P, J):
        assert m.broadcast_shape([3, 1, 4], [2, 1]) == [3, 2, 4]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert P.tolist(P.to_tensor(x)) == J.tolist(J.to_tensor(x)) == \
        x.tolist()
    assert P.to_tensor(x).tolist() == x.tolist()


def test_t_refuses_three_dims():
    with pytest.raises(ValueError, match="transpose"):
        P.t(P.ones([2, 2, 2]))


def test_repeat_interleave_with_tensor_repeats_matches_numpy():
    """The JAX package's Tensor-repeats lane raises inside its jit, so the
    port is held against ``np.repeat`` (forward) and its own scalar lane
    (gradient)."""
    x = np.random.default_rng(3).standard_normal((3, 2)).astype(np.float32)
    r = np.array([1, 0, 2], np.int64)
    t = P.to_tensor(x, stop_gradient=False)
    out = P.repeat_interleave(t, P.to_tensor(r), 0)
    np.testing.assert_array_equal(out.numpy(), np.repeat(x, r, 0))
    out.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.repeat(r[:, None], 2, 1).astype(
                                      np.float32))
