"""The port's sampled heads (``paddle_tpu_torch/nn/functional/sampled.py``)
against the JAX package's on the CPU. ``hsigmoid_loss`` and
``hierarchical_sigmoid`` draw nothing: the op table's ``sampled`` cases
hold them through both packages. The JAX package's threefry draws cannot
be matched, so for ``nce``, ``sample_logits`` and ``class_center_sample``
the arithmetic given the draws is held: the JAX package's sampler
(``_sample_classes``, and ``jax.random`` where it draws directly) is
monkeypatched to return the port's draws, and forward and gradient are
compared at 1e-5. The draws themselves are held by determinism under
``paddle.seed`` and by their distribution; ``class_center_sample``'s
model-parallel group raises, naming A10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
from paddle_tpu.nn.functional import sampled as jsampled  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core import generator as tgen  # noqa: E402
from test_torch_op_table import structured_draws_hold  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402

SEED = 31


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", cases_of("sampled"), ids=repr)
def test_sampled_heads_match_jax(case):
    check_against_jax(case)


def _gen():
    P.seed(SEED)
    return tgen.default_generator("cpu")


def _log_uniform(u, r):
    return torch.clamp(torch.exp(u * np.log(r + 1.0)).long() - 1, 0, r - 1)


def _both(fn_p, fn_j, arrays, grads=True):
    """``fn`` through both packages on the same arrays (float ones take a
    gradient of the sum of the first output): outputs and gradients."""
    out = []
    for m, fn in ((P, fn_p), (J, fn_j)):
        ts = [m.to_tensor(a, stop_gradient=not (grads and a.dtype.kind == "f"))
              for a in arrays]
        if m is P:
            P.seed(SEED)
        res = fn(*ts)
        res = res if isinstance(res, (tuple, list)) else (res,)
        if grads:
            res[0].sum().backward()
        out.append(([np.asarray(r.numpy()) for r in res],
                    [np.asarray(t.grad.numpy()) for t in ts
                     if grads and t.grad is not None]))
    return out


def _assert_close(got, ref, tol=1e-5):
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=tol,
                                       atol=tol * max(1, np.abs(b).max()))
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype))


def _nce_arrays(n=6, d=4, C=12, T=1):
    rng = np.random.default_rng(3)
    return [rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, C, (n, T)),
            rng.standard_normal((C, d)).astype(np.float32),
            rng.standard_normal((C,)).astype(np.float32)]


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_given_the_draws_matches_jax(monkeypatch, sampler):
    n, k, C = 6, 5, 12
    g = _gen()
    if sampler == "uniform":
        neg = torch.randint(0, C, (n, k), generator=g)
    else:
        neg = _log_uniform(torch.rand((n, k), generator=g), C - 1)

    def fake(key, shape, num_classes, smp, range_max=None):
        s = jnp.asarray(neg.numpy().astype(np.int32))
        if smp == "uniform":
            return s, jnp.full(shape, 1.0 / num_classes, jnp.float32)
        r = num_classes if range_max is None else range_max
        return s, jsampled._log_uniform_prob(s, r)
    monkeypatch.setattr(jsampled, "_sample_classes", fake)
    kw = dict(num_neg_samples=k, num_total_classes=C, sampler=sampler)
    got, ref = _both(lambda x, y, w, b: P.nn.functional.nce(x, y, w, b, **kw),
                     lambda x, y, w, b: J.nn.functional.nce(x, y, w, b, **kw),
                     _nce_arrays(C=C))
    _assert_close(got, ref)


def test_nce_custom_dist_and_sample_weight_match_jax(monkeypatch):
    n, k, C = 6, 4, 12
    probs = np.linspace(1, 2, C).astype(np.float32)
    probs /= probs.sum()
    neg = torch.multinomial(torch.from_numpy(probs)[None].expand(n, -1), k,
                            replacement=True, generator=_gen())
    monkeypatch.setattr(jax.random, "categorical",
                        lambda *a, **kw: jnp.asarray(neg.numpy()))
    arrays = _nce_arrays(C=C, T=2) + [np.linspace(0.5, 1.5, n).astype(
        np.float32)]
    kw = dict(num_neg_samples=k, sampler="custom_dist", custom_dist=probs)
    got, ref = _both(
        lambda x, y, w, b, s: P.nn.functional.nce(x, y, w, b,
                                                  sample_weight=s, **kw),
        lambda x, y, w, b, s: J.nn.functional.nce(x, y, w, b,
                                                  sample_weight=s, **kw),
        arrays)
    _assert_close(got, ref)


def test_nce_draws_repeat_under_seed_and_seed_argument():
    arrays = _nce_arrays()
    ts = [P.to_tensor(a) for a in arrays]
    outs = []
    for _ in range(2):
        P.seed(5)
        outs.append(P.nn.functional.nce(*ts, num_neg_samples=8).numpy())
    np.testing.assert_array_equal(*outs)
    a = P.nn.functional.nce(*ts, num_neg_samples=8, seed=9).numpy()
    P.seed(77)
    b = P.nn.functional.nce(*ts, num_neg_samples=8, seed=9).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uniq", [True, False], ids=["uniq", "draws"])
def test_sample_logits_given_the_draws_matches_jax(monkeypatch, uniq):
    n, C, S = 4, 20, 6
    g = _gen()
    if uniq:
        u = torch.rand((n, C), generator=g)
        gum = -torch.log(-torch.log(torch.clamp(
            u, min=torch.finfo(torch.float32).tiny)))
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda *a, **kw: jnp.asarray(gum.numpy()))
    else:
        neg = _log_uniform(torch.rand((n, S), generator=g), C)
        monkeypatch.setattr(jsampled, "_sample_classes", lambda *a, **kw: (
            jnp.asarray(neg.numpy().astype(np.int32)), None))
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((n, C)).astype(np.float32),
              rng.integers(0, C, (n, 2))]
    got, ref = _both(
        lambda x, y: P.nn.functional.sample_logits(x, y, S, uniq=uniq),
        lambda x, y: J.nn.functional.sample_logits(x, y, S, uniq=uniq),
        arrays)
    _assert_close(got, ref)
    if uniq:        # without replacement: distinct negatives per row
        negs = got[0][0][:, 2:]
        assert all(len(set(np.round(r, 4))) == S for r in negs)


def test_class_center_sample_given_the_draws_matches_jax(monkeypatch):
    C, S = 20, 8
    u = torch.rand((C,), generator=_gen())
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **kw: jnp.asarray(u.numpy()))
    lab = np.array([3, 7, 3, 15, 0])
    got, ref = _both(
        lambda y: P.nn.functional.class_center_sample(y, C, S),
        lambda y: J.nn.functional.class_center_sample(y, C, S), [lab],
        grads=False)
    _assert_close(got, ref)
    remap, centers = got[0]
    assert set(lab.tolist()) <= set(centers.tolist())
    np.testing.assert_array_equal(centers[remap], lab)


def test_class_center_sample_checks_and_group():
    lab = P.to_tensor(np.arange(6))
    with pytest.raises(ValueError, match="distinct positive"):
        P.nn.functional.class_center_sample(lab, 10, 4)
    with pytest.raises(ValueError, match="num_samples"):
        P.nn.functional.class_center_sample(lab, 4, 8)
    with pytest.raises(NotImplementedError, match="A10"):
        P.nn.functional.class_center_sample(lab, 10, 8, group=object())


def test_sampling_id_repeats_and_follows_the_probabilities():
    p = np.tile(np.array([[0.1, 0.2, 0.7]], np.float32), (30000, 1))
    outs = []
    for _ in range(2):
        P.seed(3)
        outs.append(P.nn.functional.sampling_id(P.to_tensor(p)).numpy())
    np.testing.assert_array_equal(*outs)
    freq = np.bincount(outs[0], minlength=3) / len(p)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.01)
    ref = np.asarray(J.nn.functional.sampling_id(J.to_tensor(p)).numpy())
    np.testing.assert_allclose(np.bincount(ref, minlength=3) / len(p), freq,
                               atol=0.02)


def test_structured_draws_repeat_under_seed_on_the_cpu():
    """The check the card runs (``structured_draws_hold``), on the CPU."""
    assert structured_draws_hold(P, "cpu") == []
