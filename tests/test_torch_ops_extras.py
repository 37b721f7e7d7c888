"""The port's op long tail (``paddle_tpu_torch/ops/extras.py``) against
the JAX package's on the CPU: every case of the op table's ``extras``
part through both packages; the reference's own cases
(``tests/test_extras_crf_ops.py``); ``center_loss`` writing the new
centers in place; the random ops by their draws (the same draws under
one ``paddle.seed``, a ``seed`` argument drawing from a generator of its
own, shapes and moments), since the JAX package's threefry draws
differ; ``filter_by_instag``'s host read refused in a capture."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import generator as tgen  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def T(x):
    return P.to_tensor(np.asarray(x))


@pytest.mark.parametrize("case", cases_of("extras"), ids=repr)
def test_extras_ops_match_jax(case):
    check_against_jax(case)


def test_bpr_and_modified_huber_numpy():
    x = np.array([[1.0, 2.0, 0.5]], np.float32)
    got = P.ops.bpr_loss(T(x), T([[1]])).numpy()
    want = np.mean([np.log1p(np.exp(1.0 - 2.0)), np.log1p(np.exp(0.5 - 2.0))])
    np.testing.assert_allclose(got[0, 0], want, rtol=1e-6)
    inter = np.array([[-2.0], [0.5], [2.0]], np.float32)
    got = P.ops.modified_huber_loss(T(inter), T(np.ones((3, 1)))).numpy()
    np.testing.assert_allclose(got.ravel(), [8.0, 0.25, 0.0])


def test_center_loss_updates_centers_in_place():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 3).astype(np.float32)
    lab = np.array([0, 1, 1, 3, 0])
    c = rng.randn(4, 3).astype(np.float32)
    centers = P.to_tensor(c.copy())
    loss, new_c = P.ops.center_loss(T(x), T(lab), centers, alpha=0.5)
    jloss, jnew = J.ops.center_loss(J.to_tensor(x), J.to_tensor(lab),
                                    J.to_tensor(c), alpha=0.5)
    np.testing.assert_allclose(centers.numpy(), np.asarray(jnew.numpy()),
                               rtol=1e-6)
    np.testing.assert_array_equal(centers.numpy(), new_c.numpy())
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss.numpy()),
                               rtol=1e-6)
    want = 0.5 * ((x - c[lab]) ** 2).sum(1, keepdims=True)
    np.testing.assert_allclose(loss.numpy(), want, rtol=1e-6)
    kept = P.to_tensor(c.copy())
    P.ops.center_loss(T(x), T(lab), kept, update_center=False)
    np.testing.assert_array_equal(kept.numpy(), c)


def test_spp_and_unpool_examples():
    x = np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4)
    out = P.ops.spp(T(x), 2).numpy()
    assert out.shape == (1, 2 * (1 + 4))
    np.testing.assert_allclose(out[0, :2], [15, 31])
    pooled = np.array([[[[5.0]]]], np.float32)
    up = P.ops.max_unpool2d(T(pooled), T(np.array([[[[3]]]])), 2).numpy()
    np.testing.assert_array_equal(up.ravel(), [0, 0, 0, 5])


def _draws(make, seed=11):
    P.seed(seed)
    a = make()
    P.seed(seed)
    b = make()
    return [np.asarray(v.numpy()) for v in (a if isinstance(a, tuple)
                                            else (a,))], \
        [np.asarray(v.numpy()) for v in (b if isinstance(b, tuple)
                                         else (b,))]


def test_shuffle_batch_permutes_rows_and_repeats_under_seed():
    x = T(np.arange(40, dtype=np.float32).reshape(20, 2))
    (out, idx), (out2, idx2) = _draws(lambda: P.ops.shuffle_batch(x))
    np.testing.assert_array_equal(out, out2)
    np.testing.assert_array_equal(np.sort(idx), np.arange(20))
    np.testing.assert_array_equal(out, x.numpy()[idx])
    assert idx.dtype == np.int64


def test_seed_argument_draws_from_a_generator_of_its_own():
    x = T(np.arange(20, dtype=np.float32).reshape(10, 2))
    before = tgen.default_generator("cpu").get_state()
    a = P.ops.shuffle_batch(x, seed=7)[1].numpy()
    assert torch.equal(tgen.default_generator("cpu").get_state(), before)
    P.seed(123)
    b = P.ops.shuffle_batch(x, seed=7)[1].numpy()
    np.testing.assert_array_equal(a, b)
    u = P.ops.uniform_random_batch_size_like(x, [1, 3], seed=5).numpy()
    np.testing.assert_array_equal(
        u, P.ops.uniform_random_batch_size_like(x, [1, 3], seed=5).numpy())


@pytest.mark.parametrize("kind", ["uniform", "gaussian"])
def test_batch_size_like_draws(kind):
    x = T(np.zeros((50000, 3), np.float32))
    fn = getattr(P.ops, f"{kind}_random_batch_size_like")
    kw = dict(low=-2.0, high=4.0) if kind == "uniform" else \
        dict(mean=1.0, std=3.0)
    (a,), (b,) = _draws(lambda: fn(x, [1, 2], **kw))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (50000, 2) and a.dtype == np.float32
    if kind == "uniform":
        assert a.min() >= -2 and a.max() < 4 and abs(a.mean() - 1) < 0.03
    else:
        assert abs(a.mean() - 1) < 0.03 and abs(a.std() - 3) < 0.03
    # the JAX package's draws: the same shape, type and moments
    ref = np.asarray(getattr(J.ops, f"{kind}_random_batch_size_like")(
        J.to_tensor(np.zeros((50000, 3), np.float32)), [1, 2],
        **kw).numpy())
    assert ref.shape == a.shape and abs(ref.mean() - a.mean()) < 0.06


def test_filter_by_instag_reads_tensor_tags_on_the_host(monkeypatch):
    ins = T(np.ones((3, 2), np.float32))
    tags = T(np.array([[1, 0], [2, 2], [3, 1]]))
    out, mask, _ = P.ops.filter_by_instag(ins, tags, T([1]))
    np.testing.assert_array_equal(mask.numpy(), [True, False, True])
    monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    with pytest.raises(ValueError, match="capture"):
        P.ops.filter_by_instag(ins, tags, T([1]))
    out, mask, _ = P.ops.filter_by_instag(ins, tags, [1])   # a static list
    np.testing.assert_array_equal(mask.numpy(), [True, False, True])
