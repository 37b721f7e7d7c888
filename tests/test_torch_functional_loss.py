"""The port's losses (``nn/functional/loss.py``) against the JAX
package's on the CPU: every case of the op table's loss part
(``tests/test_torch_op_table.py`` ``OP_CASES``: each reduction, weights,
``ctc_loss`` with an impossible path, the greedy CTC decoder in both
layouts) through both packages on the same seeded NumPy inputs, forward
at 1e-5 and the gradient of a seeded cotangent at 1e-4."""
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


@pytest.mark.parametrize("case", cases_of("loss"), ids=repr)
def test_functional_matches_jax(case):
    check_against_jax(case)
