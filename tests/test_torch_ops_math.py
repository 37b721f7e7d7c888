"""The port's elementwise, matrix and reduction ops (the first half of
``paddle_tpu_torch/ops/math.py``) against the JAX package's on the CPU:
every case of the op table's math part
(``tests/test_torch_op_table.py`` ``OP_CASES``) through both packages on the
same seeded NumPy inputs, the forward at 1e-5 (integer and index outputs
bitwise; dtypes equal up to the JAX package's narrowing of 64-bit types),
for float inputs the gradient of a seeded cotangent at 1e-4, and the op
names the AMP handler sees during the call, equal. The tie cases of the
reductions and ``maximum``/``minimum`` are held here, on the CPU only;
the search half is ``test_torch_ops_search.py``."""
import contextlib

import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu.ops.dispatch as jdispatch  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_op_table import OP_CASES, assert_case_close, run_case  # noqa: E402

# JAX runs without 64-bit types: the reference narrows them
NARROW = {"int64": "int32", "float64": "float32", "complex128": "complex64"}


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def cases_of(*modules):
    return [c for c in OP_CASES if c.module in modules and c.ref]


@contextlib.contextmanager
def recording_amp_names(m, names):
    """Record the op names package ``m``'s AMP handler sees with a tensor
    among the arguments (the reference calls its handler only then)."""
    if m is J:
        prev = jdispatch._AMP_HANDLER[0]

        def rec(name, tensors):
            names.append(name)
            return tensors
        jdispatch._AMP_HANDLER[0] = rec
    else:
        prev = tdispatch._AMP_HANDLER[0]

        def rec(name, args):
            if any(isinstance(a, torch.Tensor) for a in args):
                names.append(name)
            return args
        tdispatch.register_amp_handler(rec)
    try:
        yield
    finally:
        if m is J:
            jdispatch._AMP_HANDLER[0] = prev
        else:
            tdispatch.register_amp_handler(prev)


def check_against_jax(case):
    """``case`` through the port and the JAX package on the CPU: values,
    gradients, dtypes (by name, up to the JAX package's narrowing) and
    the op names the AMP handler sees during the call."""
    tnames, jnames = [], []
    got = run_case(P, case, around_op=lambda: recording_amp_names(
        P, tnames))
    ref = run_case(J, case, around_op=lambda: recording_amp_names(
        J, jnames))
    assert_case_close(case, got, ref, "port vs JAX")
    assert tnames == jnames, (case, tnames, jnames)
    for i, (a, b) in enumerate(zip(got[0], ref[0])):
        name = a.dtype.name
        assert NARROW.get(name, name) == b.dtype.name or (
            name == b.dtype.name), (case, i, a.dtype, b.dtype)


@pytest.mark.parametrize("case", cases_of("math"), ids=repr)
def test_math_op_matches_jax(case):
    check_against_jax(case)
