"""The port's search, sort, indexing and tail ops (the second half of
``paddle_tpu_torch/ops/math.py``: ``argmax`` ... ``topk``, ``mode``,
``where``/``nonzero``, gathers and scatters, ``unique``/``bincount``/
``histogram``, the norms, ``cummin`` ... ``unflatten``) against the JAX
package's on the CPU: every case of the op table's ``search`` part
(``tests/test_torch_op_table.py`` ``OP_CASES``) through both packages, held
as ``test_torch_ops_math.py`` holds the elementwise half: forward,
gradient, dtypes and the AMP handler's op names. The tie cases of sort,
argsort, topk, kthvalue, mode, argmax and cummin are held here, on the
CPU only."""
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


@pytest.mark.parametrize("case", cases_of("search"), ids=repr)
def test_search_op_matches_jax(case):
    check_against_jax(case)
