"""The port's common functionals and norms (``nn/functional/common.py``,
``nn/functional/norm.py``) against the JAX package's on the CPU: every
case of the op table's common and norm parts (``tests/test_torch_op_table.py``
``OP_CASES``) through both packages on the same seeded NumPy inputs,
forward at 1e-5 and the gradient of a seeded cotangent at 1e-4. The
dropouts in training are held by determinism under ``seed`` and their
moments in ``test_torch_ops_creation_linalg.py``."""
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


@pytest.mark.parametrize("case", cases_of("common", "norm"), ids=repr)
def test_functional_matches_jax(case):
    check_against_jax(case)
