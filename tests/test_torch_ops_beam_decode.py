"""The port's beam ops (``paddle_tpu_torch/ops/beam.py``) and beam decoder
(``nn/beam_decode.py``) against the JAX package's on the CPU: every case
of the op table's ``beam`` part through both packages; the reference's
own cases (``tests/test_sequence_beam_ops.py``, and the decoder against
brute-force enumeration, ``test_nn_parity_r5.py:50-90``); top-k ties in
``lax.top_k``'s order; and a tiny GPT (2 layers, width 64) decoded by
``dynamic_decode`` with both cells a user writes (the incremental cache,
reordered by parent every step, and the full prefix), ids equal to the
JAX package's and scores at 1e-5."""
import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from test_torch_op_table import gpt_beam_cells  # noqa: E402
from test_torch_ops_math import cases_of, check_against_jax  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


def T(x):
    return P.to_tensor(np.asarray(x))


@pytest.mark.parametrize("case", cases_of("beam"), ids=repr)
def test_beam_ops_match_jax(case):
    check_against_jax(case)


def test_gather_tree_reference_values():
    ids = np.array([[[2, 2], [6, 1]], [[3, 9], [6, 1]], [[0, 1], [9, 0]]])
    parents = np.array([[[0, 0], [1, 1]], [[1, 0], [1, 0]],
                        [[0, 0], [0, 1]]])
    out = P.nn.functional.gather_tree(T(ids), T(parents)).numpy()
    np.testing.assert_array_equal(out, [[[2, 2], [1, 6]], [[3, 3], [6, 1]],
                                        [[0, 1], [9, 0]]])


def test_beam_search_step_and_finished_beam():
    scores = np.full((1, 2, 4), -np.inf, np.float32)
    scores[0, 0] = [-1.0, -0.1, -5.0, -3.0]
    scores[0, 1] = [-2.0, -0.2, -6.0, -4.0]
    tok, sc, parent = P.ops.beam_search(
        T(np.array([[1, 2]])), T(np.array([[0.0, -1.0]], np.float32)), None,
        T(scores), beam_size=2, end_id=3)
    np.testing.assert_array_equal(tok.numpy(), [[1, 1]])
    np.testing.assert_allclose(sc.numpy(), [[-0.1, -0.2]], rtol=1e-6)
    np.testing.assert_array_equal(parent.numpy(), [[0, 1]])
    scores = np.zeros((1, 2, 4), np.float32) - 10.0
    scores[0, 1, 1] = -0.7
    tok, sc, _ = P.ops.beam_search(
        T(np.array([[3, 2]])), T(np.array([[-0.5, -1.0]], np.float32)), None,
        T(scores), beam_size=2, end_id=3)
    assert tok.numpy()[0, 0] == 3 and abs(sc.numpy()[0, 0] + 0.5) < 1e-6


def test_beam_search_ties_keep_the_lower_index_first():
    scores = np.zeros((2, 3, 4), np.float32)        # every candidate tied
    args = (np.zeros((2, 3), np.int64), np.zeros((2, 3), np.float32))
    got = P.ops.beam_search(T(args[0]), T(args[1]), None, T(scores), 3, 3)
    ref = J.ops.beam_search(J.to_tensor(args[0]), J.to_tensor(args[1]),
                            None, J.to_tensor(scores), 3, 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r.numpy()))
    np.testing.assert_array_equal(got[2].numpy(), [[0, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(got[0].numpy(), [[0, 1, 2], [0, 1, 2]])


def test_ctc_align_and_edit_distance_examples():
    out, n = P.ops.ctc_align(T(np.array([[0, 1, 1, 0, 2, 2, 0]])), blank=0)
    assert n.numpy().tolist() == [2]
    np.testing.assert_array_equal(out.numpy()[0, :2], [1, 2])
    hyp, ref = np.array([[1, 2, 3, 0]]), np.array([[1, 3, 3]])
    d, _ = P.ops.edit_distance(T(hyp), T(ref), normalized=False,
                               input_length=T([3]), label_length=T([3]))
    assert d.numpy()[0, 0] == 1.0


def _table_cell(m, table):
    tab = m.to_tensor(table)

    def cell(ids, states):
        return m.ops.gather(tab, ids), states
    return cell


@pytest.mark.parametrize("m", [P, J], ids=["port", "jax"])
def test_beam_search_decoder_matches_bruteforce(m):
    rng = np.random.RandomState(3)
    V, steps, K = 5, 3, 3
    table = rng.randn(V, V).astype(np.float32) * 2.0
    dec = m.nn.BeamSearchDecoder(_table_cell(m, table), start_token=0,
                                 end_token=V - 1, beam_size=K)
    ids, scores = m.nn.dynamic_decode(
        dec, inits=m.to_tensor(np.zeros((1, 2), np.float32)),
        max_step_num=steps)
    assert tuple(ids.shape) == (1, steps, K)
    logp = np.log(np.exp(table) / np.exp(table).sum(-1, keepdims=True))
    best = []
    for seq in itertools.product(range(V), repeat=steps):
        s, prev, done = 0.0, 0, False
        for tok in seq:
            if done:
                s = s if tok == V - 1 else -np.inf
                continue
            s += logp[prev, tok]
            prev, done = tok, tok == V - 1
        best.append((s, seq))
    best.sort(key=lambda t: -t[0])
    np.testing.assert_allclose(np.sort(np.asarray(scores.numpy())[0])[::-1],
                               [b[0] for b in best[:K]], rtol=1e-5)
    got = {tuple(np.asarray(ids.numpy())[0, :, k]) for k in range(K)}
    assert got == {b[1] for b in best[:K]}


def test_dynamic_decode_rejects_unknown_keywords_and_no_state():
    dec = P.nn.BeamSearchDecoder(_table_cell(P, np.eye(3, dtype=np.float32)),
                                 0, 2, 2)
    with pytest.raises(TypeError, match="impute_finished"):
        P.nn.dynamic_decode(dec, inits=T(np.zeros((1, 1))),
                            impute_finished=True)
    with pytest.raises(ValueError, match="inits"):
        P.nn.dynamic_decode(dec, inits=None)


def test_dynamic_decode_reorders_namedtuple_and_torch_leaves():
    """A state tree of a namedtuple of Tensors and a raw torch tensor:
    every leaf is tiled to the beam and reordered by parent, each keeping
    its type."""
    table = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    cache = P.nn.MultiHeadAttention.Cache
    seen = []

    def cell(ids, states):
        seen.append(states)
        c, raw = states
        return P.ops.gather(P.to_tensor(table), ids), (
            cache(c.k + 1.0, c.v), raw + 1)
    dec = P.nn.BeamSearchDecoder(cell, 0, 3, 2)
    inits = (cache(T(np.array([[1.0], [2.0]], np.float32)),
                   T(np.zeros((2, 1), np.float32))),
             torch.arange(2.0)[:, None])
    P.nn.dynamic_decode(dec, inits=inits, max_step_num=3)
    c, raw = seen[-1]
    assert isinstance(c, cache) and isinstance(c.k, P.Tensor)
    assert isinstance(raw, torch.Tensor)
    # rows of batch entry 0 only ever hold entry 0's lineage, of 1 only 1's
    np.testing.assert_array_equal(c.k.numpy().ravel(), [3, 3, 4, 4])
    np.testing.assert_array_equal(raw.numpy().ravel(), [2, 2, 3, 3])


@pytest.fixture(scope="module")
def gpts():
    J.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()},
        "cpu"), strict=True)
    return jm, pm


@pytest.mark.parametrize("cached", [True, False], ids=["cache", "prefix"])
def test_tiny_gpt_beam_search_matches_jax(gpts, cached):
    jm, pm = gpts
    prompts = np.random.default_rng(0).integers(0, 64, (2, 8))
    prompts[:, -1] = 7
    out = []
    for m, model in ((J, jm), (P, pm)):
        cell, inits = gpt_beam_cells(m, model, prompts, cached)
        dec = m.nn.BeamSearchDecoder(cell, start_token=7, end_token=63,
                                     beam_size=4)
        ids, scores = m.nn.dynamic_decode(dec, inits=inits, max_step_num=4)
        out.append((np.asarray(ids.numpy()), np.asarray(scores.numpy())))
    (jids, jsc), (pids, psc) = out
    assert pids.shape == (2, 4, 4)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_allclose(psc, jsc, rtol=1e-5,
                               atol=1e-5 * np.abs(jsc).max())
