"""The port's segment reductions and sequence ops
(``paddle_tpu_torch/ops/{segment,sequence}.py``) against the JAX
package's on the CPU: every case of the op table's ``segment`` and
``sequence`` parts (``tests/test_torch_op_table.py``) through both
packages (forward at 1e-5, integer outputs bitwise, gradients at 1e-4,
dtypes, the op names the AMP handler sees); the reference's own cases of
``tests/test_sequence_beam_ops.py`` and ``test_sampled_segment_ops.py``;
the host reads refused inside a capture, and the two ``sequence_mask``
forms."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.fixture
def capturing(monkeypatch):
    """The port as it is inside a CUDA graph capture."""
    monkeypatch.setattr(tdispatch, "capturing", lambda: True)


def T(x):
    return P.to_tensor(np.asarray(x))


@pytest.mark.parametrize("case", cases_of("segment", "sequence"), ids=repr)
def test_segment_and_sequence_ops_match_jax(case):
    check_against_jax(case)


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_segment_ops_numpy(kind):
    rng = np.random.RandomState(0)
    data = rng.randn(7, 3).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 1, 3, 3])
    out = getattr(P.incubate, f"segment_{kind}")(T(data), T(ids)).numpy()
    fn = {"sum": np.sum, "mean": np.mean, "max": np.max, "min": np.min}[kind]
    want = np.zeros((4, 3), np.float32)
    for s in (0, 1, 3):
        want[s] = fn(data[ids == s], axis=0)
    np.testing.assert_allclose(out, want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["max", "min"])
def test_segment_extreme_gradient_splits_over_ties(kind):
    d = P.to_tensor(np.array([[2.0], [2.0], [1.0]], np.float32),
                    stop_gradient=False)
    if kind == "min":
        d = P.to_tensor(np.array([[1.0], [1.0], [2.0]], np.float32),
                        stop_gradient=False)
    out = getattr(P.incubate, f"segment_{kind}")(d, T([0, 0, 0]))
    out.sum().backward()
    np.testing.assert_array_equal(d.grad.numpy().ravel(), [0.5, 0.5, 0.0])


def test_segment_pool_dispatch_and_grad():
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(3, 2),
                    stop_gradient=False)
    out = P.incubate.segment_pool(x, T([0, 0, 1]), "MEAN")
    np.testing.assert_allclose(out.numpy(), [[1, 2], [4, 5]])
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[.5, .5], [.5, .5], [1, 1]])
    with pytest.raises(ValueError, match="unknown pooltype"):
        P.incubate.segment_pool(x, T([0, 0, 1]), "MEDIAN")


def test_pad_unpad_roundtrip():
    flat = np.arange(12, dtype=np.float32).reshape(6, 2)
    lens = np.array([2, 1, 3])
    padded, n = P.ops.sequence_pad(T(flat), 0.0, maxlen=3, length=T(lens))
    p = padded.numpy()
    np.testing.assert_allclose(p[0, :2], flat[:2])
    np.testing.assert_allclose(p[1, :1], flat[2:3])
    np.testing.assert_allclose(p[2], flat[3:6])
    assert (p[0, 2] == 0).all() and (p[1, 1:] == 0).all()
    np.testing.assert_allclose(P.ops.sequence_unpad(padded, n).numpy(), flat)


def test_sequence_concat_and_erase_examples():
    data, total = P.ops.sequence_concat(
        [T(np.array([[1, 2, 0]], np.float32)),
         T(np.array([[7, 8, 9]], np.float32))], [T([2]), T([3])])
    assert total.numpy().tolist() == [5]
    np.testing.assert_allclose(data.numpy()[0, :5], [1, 2, 7, 8, 9])
    out, n = P.ops.sequence_erase(T(np.array([[3, 5, 3, 7], [5, 5, 1, 0]])),
                                  [5], T([4, 3]))
    assert n.numpy().tolist() == [3, 1]
    np.testing.assert_array_equal(out.numpy()[0, :3], [3, 3, 7])
    assert out.numpy()[1, 0] == 1


def test_sequence_conv_matches_manual():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 3).astype(np.float32)
    w = rng.randn(9, 5).astype(np.float32)
    out = P.ops.sequence_conv(T(x), T(w), context_length=3,
                              context_start=-1).numpy()
    padded = np.pad(x, [(0, 0), (1, 1), (0, 0)])
    ctx = np.concatenate([padded[:, :-2], padded[:, 1:-1], padded[:, 2:]],
                         axis=-1)
    np.testing.assert_allclose(out, ctx @ w, rtol=1e-4, atol=1e-5)


def test_im2sequence_example():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = P.ops.im2sequence(T(x), (2, 2), strides=(2, 2)).numpy()
    assert out.shape == (4, 4)
    np.testing.assert_allclose(out[0], [0, 1, 4, 5])


def test_ops_and_functional_sequence_mask_differ():
    """``ops.sequence_mask`` takes the lengths' maximum, the functional
    form its input's last axis, in both packages."""
    lens = np.array([1, 4, 2], np.int64)
    got_ops = P.ops.sequence_mask(T(lens)).numpy()
    got_f = P.nn.functional.sequence_mask(T(lens)).numpy()
    assert got_ops.shape == (3, 4) and got_f.shape == (3, 3)
    np.testing.assert_array_equal(
        got_ops, np.asarray(J.ops.sequence_mask(J.to_tensor(lens)).numpy()))
    np.testing.assert_array_equal(got_f, np.asarray(
        J.nn.functional.sequence_mask(J.to_tensor(lens)).numpy()))
    assert P.sequence_mask is P.ops.sequence_mask
    assert P.nn.functional.sequence_mask is not P.ops.sequence_mask


@pytest.mark.parametrize("call", [
    lambda: P.incubate.segment_sum(T(np.ones((3, 2), np.float32)),
                                   T([0, 0, 1])),
    lambda: P.ops.sequence_mask(T([1, 3])),
    lambda: P.ops.sequence_pad(T(np.ones((4, 2), np.float32)), 0.0,
                               length=T([1, 3])),
    lambda: P.ops.sequence_unpad(T(np.ones((2, 3), np.float32)), T([1, 3])),
    lambda: P.ops.sequence_expand(T(np.ones((2, 3), np.float32)),
                                  T([1, 3])),
], ids=["segment_sum", "sequence_mask", "sequence_pad", "sequence_unpad",
        "sequence_expand"])
def test_host_reads_raise_under_capture(capturing, call):
    with pytest.raises(ValueError, match="capture"):
        call()


def test_device_forms_run_under_capture(capturing):
    x = T(np.arange(8, dtype=np.float32).reshape(4, 2))
    assert P.incubate.segment_max(x, T([0, 0, 1, 2]),
                                  num_segments=3).shape == [3, 2]
    assert P.ops.sequence_mask(T([1, 3]), maxlen=4).shape == [2, 4]
    out, _ = P.ops.sequence_pad(x, 0.0, maxlen=3, length=T([1, 3]))
    np.testing.assert_allclose(out.numpy()[1], [[2, 3], [4, 5], [6, 7]])
    data, n = P.ops.sequence_concat([T(np.ones((1, 2, 1), np.float32))] * 2,
                                    [T([1]), T([2])])
    assert data.shape == [1, 4, 1] and n.numpy().tolist() == [3]
