"""The port's creation and linear-algebra ops (``ops/creation.py``,
``ops/linalg.py``) against the JAX package's on the CPU: every
deterministic case of the op table's creation and linalg parts
(``tests/test_torch_op_table.py`` ``OP_CASES``; factorisations compared where
their conventions agree: singular values and rebuilt products, sorted
eigenvalues), ``empty``/``empty_like`` by shape and dtype, the random ops
and random initializers by determinism under ``seed`` and by bounds and
moments, and every creation op's placement (``set_device``'s device, or
its input's)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core.dtypes import dtype_name  # noqa: E402
from test_torch_op_table import random_ops_hold  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", cases_of("creation", "linalg"), ids=repr)
def test_creation_and_linalg_op_matches_jax(case):
    check_against_jax(case)


@pytest.mark.parametrize("make", [
    lambda m: m.empty([2, 3]), lambda m: m.empty([4], "int32"),
    lambda m: m.empty_like(m.ones([3, 2]), "float64"),
], ids=["empty", "empty_int32", "empty_like"])
def test_empty_has_the_shape_and_dtype(make):
    t, j = make(P), make(J)
    assert t.shape == list(j.shape)
    name = dtype_name(t.dtype)
    assert {"float64": "float32"}.get(name, name) == np.dtype(j.dtype).name


def test_random_ops_repeat_under_seed_and_hold_their_moments():
    assert random_ops_hold(P, "cpu") == []


def test_random_ops_shapes_and_dtypes_match_jax():
    cases = [lambda m: m.uniform([2, 3]), lambda m: m.rand([4]),
             lambda m: m.randn([2, 2], "float64"),
             lambda m: m.normal(0.0, 1.0, [3]),
             lambda m: m.randint(0, 4, [5]), lambda m: m.randperm(6),
             lambda m: m.bernoulli(m.full([3], 0.5)),
             lambda m: m.multinomial(m.to_tensor([0.5, 0.5]), 2),
             lambda m: m.truncated_normal([2, 5])]
    for make in cases:
        t, j = make(P), make(J)
        name = dtype_name(t.dtype)
        assert t.shape == list(j.shape)
        assert {"int64": "int32", "float64": "float32"}.get(name, name) \
            == np.dtype(j.dtype).name


def test_seed_argument_gives_its_own_stream():
    a = P.uniform([5], seed=3)
    P.seed(99)
    b = P.uniform([5], seed=3)
    c = P.uniform([5])
    assert np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(b.numpy(), c.numpy())


def test_creation_ops_follow_set_device_and_their_input():
    tdevice._CURRENT[0] = None
    if not torch.cuda.is_available():
        for make in (lambda: P.linspace(0, 1, 3), lambda: P.eye(2),
                     lambda: P.rand([2]), lambda: P.randperm(3),
                     lambda: P.empty([2])):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    P.set_device("cpu")
    x = P.to_tensor([1.0, 2.0])
    for t in (P.linspace(0, 1, 3), P.eye(2), P.rand([2]), P.diag(x),
              P.one_hot(P.to_tensor([1]), 3), P.bernoulli(x * 0.2)):
        assert t.place == P.CPUPlace()
