"""The port's CRF ops (``paddle_tpu_torch/ops/crf.py``) against the JAX
package's on the CPU: every case of the op table's ``crf`` part through
both packages; the reference's own cases
(``tests/test_extras_crf_ops.py``: brute force over every path, the
BOS/EOS layout, chunk counts); the fp32 forward recursion over 128 steps
at 1e-5; the ops capturable (no host read but ``chunk_eval``'s); and a
tiny BERT-CRF tagger (``bert_crf_tagger``, dropout 0) through
``Model``: its loss and 3 SGD steps at 1e-4, its Viterbi paths and
``chunk_eval`` F1 equal to the JAX package's."""
import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
from paddle_tpu.models import bert as jbert  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.models import bert as tbert  # noqa: E402
from paddle_tpu_torch.ops import dispatch as tdispatch  # noqa: E402
from test_torch_op_table import (NER_TAGS, bert_crf_tagger,  # noqa: E402
                                 iob_tags)
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def T(x):
    return P.to_tensor(np.asarray(x))


@pytest.mark.parametrize("case", cases_of("crf"), ids=repr)
def test_crf_ops_match_jax(case):
    check_against_jax(case)


def _brute(em, tr):
    C = em.shape[1]
    start, stop, W = tr[0], tr[1], tr[2:]
    scores = {}
    for path in itertools.product(range(C), repeat=em.shape[0]):
        s = start[path[0]] + stop[path[-1]] + sum(
            em[t, p] for t, p in enumerate(path))
        s += sum(W[a, b] for a, b in zip(path[:-1], path[1:]))
        scores[path] = s
    return scores


def test_linear_chain_crf_and_decoding_brute_force():
    rng = np.random.RandomState(0)
    em = rng.randn(1, 4, 3).astype(np.float32)
    tr = rng.randn(5, 3).astype(np.float32)
    scores = _brute(em[0], tr)
    label = np.array([[2, 0, 1, 1]])
    logz = np.log(np.sum(np.exp(list(scores.values()))))
    nll = P.ops.linear_chain_crf(T(em), T(tr), T(label)).numpy()
    np.testing.assert_allclose(nll[0, 0], logz - scores[(2, 0, 1, 1)],
                               rtol=1e-5)
    best = max(scores, key=scores.get)
    np.testing.assert_array_equal(
        P.ops.crf_decoding(T(em), T(tr)).numpy()[0], best)


def test_crf_grads_flow_to_emission_and_transition():
    rng = np.random.RandomState(1)
    em = P.to_tensor(rng.randn(2, 5, 3).astype(np.float32),
                     stop_gradient=False)
    tr = P.to_tensor(rng.randn(5, 3).astype(np.float32), stop_gradient=False)
    P.ops.linear_chain_crf(em, tr, T(rng.randint(0, 3, (2, 5))),
                           T([5, 2])).sum().backward()
    assert np.abs(em.grad.numpy()).sum() > 0
    assert np.abs(tr.grad.numpy()).sum() > 0
    assert np.all(em.grad.numpy()[1, 2:] == 0)     # past the length


def test_viterbi_decode_bos_eos_convention():
    rng = np.random.RandomState(2)
    C = 5
    pot = rng.randn(2, 4, C).astype(np.float32)
    tr = rng.randn(C, C).astype(np.float32)
    score, path = P.ops.viterbi_decode(T(pot), T(tr), T([4, 4]))
    for b in range(2):
        best, arg = -np.inf, None
        for p in itertools.product(range(C), repeat=4):
            s = tr[C - 2, p[0]] + tr[p[-1], C - 1] + sum(
                pot[b, t, q] for t, q in enumerate(p)) + sum(
                tr[a, c] for a, c in zip(p[:-1], p[1:]))
            if s > best:
                best, arg = s, p
        np.testing.assert_allclose(score.numpy()[b], best, rtol=1e-5)
        np.testing.assert_array_equal(path.numpy()[b], arg)


def test_chunk_eval_iob_counts():
    # B-0 I-0 O B-1 | B-0 O O B-1 (tag 4 is O for 2 types)
    inf = np.array([[0, 1, 4, 2], [0, 4, 4, 2]])
    lab = np.array([[0, 1, 4, 2], [0, 1, 4, 4]])
    p, r, f1, n_inf, n_lab, n_cor = P.ops.chunk_eval(T(inf), T(lab), "IOB",
                                                     2)
    assert (n_inf, n_lab, n_cor) == (4, 3, 2)
    np.testing.assert_allclose((p, r), (0.5, 2 / 3))


def test_crf_forward_over_128_steps_at_1e5():
    rng = np.random.default_rng(5)
    em = (3 * rng.standard_normal((2, 128, NER_TAGS))).astype(np.float32)
    tr = rng.standard_normal((NER_TAGS + 2, NER_TAGS)).astype(np.float32)
    lab = rng.integers(0, NER_TAGS, (2, 128))
    n = np.array([128, 77])
    got = P.ops.linear_chain_crf(T(em), T(tr), T(lab), T(n)).numpy()
    ref = np.asarray(J.ops.linear_chain_crf(
        J.to_tensor(em), J.to_tensor(tr), J.to_tensor(lab),
        J.to_tensor(n)).numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_array_equal(
        P.ops.crf_decoding(T(em), T(tr), length=T(n)).numpy(),
        np.asarray(J.ops.crf_decoding(J.to_tensor(em), J.to_tensor(tr),
                                      length=J.to_tensor(n)).numpy()))


def test_crf_runs_under_capture_and_chunk_eval_refuses(monkeypatch):
    monkeypatch.setattr(tdispatch, "capturing", lambda: True)
    rng = np.random.RandomState(3)
    em, tr = T(rng.randn(2, 4, 3).astype(np.float32)), \
        T(rng.randn(5, 3).astype(np.float32))
    n = T([4, 2])
    assert P.ops.linear_chain_crf(em, tr, T(np.zeros((2, 4), np.int64)),
                                  n).shape == [2, 1]
    assert P.ops.crf_decoding(em, tr, length=n).shape == [2, 4]
    with pytest.raises(ValueError, match="capture"):
        P.ops.chunk_eval(T(np.zeros((2, 4))), T(np.zeros((2, 4))), "IOB", 1)


# -- the tiny BERT-CRF tagger ---------------------------------------------------

CFG = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=32,
           hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _taggers():
    J.seed(0)
    jnet, jloss = bert_crf_tagger(J, jbert.BertModel(jbert.BertConfig(**CFG)),
                                  CFG["hidden_size"])
    tnet, tloss = bert_crf_tagger(
        P, tbert.BertModel(tbert.BertConfig(**CFG), device="cpu", seed=None),
        CFG["hidden_size"])
    tnet.load_state_dict(P.state_dict_from_reference(
        {k: np.array(v._data) for k, v in jnet.state_dict().items()}, "cpu"),
        strict=True)
    return (jnet, jloss), (tnet, tloss)


def _batch():
    rng = np.random.default_rng(7)
    n = np.array([16, 9, 12, 5])
    ids = rng.integers(0, CFG["vocab_size"], (4, 16))
    return ids, n, iob_tags(rng, n, 16)


def test_tiny_bert_crf_trains_and_decodes_as_jax():
    (jnet, jloss), (tnet, tloss) = _taggers()
    ids, n, tags = _batch()
    models = []
    for m, net, loss in ((J, jnet, jloss), (P, tnet, tloss)):
        model = m.Model(net)
        model.prepare(m.optimizer.SGD(learning_rate=0.1,
                                      parameters=net.parameters()), loss)
        losses = [model.train_batch([m.to_tensor(ids), m.to_tensor(n)],
                                    [m.to_tensor(tags)])[0]
                  for _ in range(3)]
        models.append((model, losses))
    (jm, jl), (tm, tl) = models
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for (k, a), b in zip(tnet.state_dict().items(),
                         jnet.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    tp = tm.predict_batch([P.to_tensor(ids), P.to_tensor(n)])
    jp = jm.predict_batch([J.to_tensor(ids), J.to_tensor(n)])
    tpath, jpath = tp[2].numpy(), np.asarray(jp[2])
    np.testing.assert_array_equal(tpath, jpath)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), rtol=1e-4,
                               atol=1e-4)
    f_t = P.ops.chunk_eval(T(tpath), T(tags), "IOB", 3, T(n))
    f_j = J.ops.chunk_eval(J.to_tensor(jpath), J.to_tensor(tags), "IOB", 3,
                           J.to_tensor(n))
    assert f_t == f_j
    ev_t = tm.eval_batch([P.to_tensor(ids), P.to_tensor(n)],
                         [P.to_tensor(tags)])[0]
    ev_j = jm.eval_batch([J.to_tensor(ids), J.to_tensor(n)],
                         [J.to_tensor(tags)])[0]
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-4)
