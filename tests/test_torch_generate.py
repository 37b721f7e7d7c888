"""``GPTForCausalLM.generate`` of the port against the JAX package's, on
the same weights (vocab 64, hidden 64, 2 layers, 2 heads): greedy tokens
equal in all three cache modes (static slot, concat, recompute) and equal
to the JAX package's; seeded top-k sampling equal between the static and
concat lanes (not across packages: the noise differs); eos freezing and
trimming as in the JAX package; the two fallbacks to the concat cache;
past the position table the JAX package's tokens in every mode; greedy
draws nothing from the port's generator."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core import generator as tgen  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
             max_position_embeddings=64, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
IDS = np.array([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
MODES = [True, "concat", False]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()},
        "cpu"), strict=True)
    return jm, pm


def _jax(jm, ids, **kw):
    return np.asarray(jm.generate(Tensor(jnp.asarray(ids)), **kw)._data)


@pytest.fixture(scope="module")
def jax_greedy(models):
    return _jax(models[0], IDS, max_length=16)


@pytest.mark.parametrize("use_cache", MODES, ids=["static", "concat",
                                                  "recompute"])
def test_greedy_equals_jax_in_every_mode(models, jax_greedy, use_cache):
    _, pm = models
    out = pm.generate(IDS, max_length=16, use_cache=use_cache)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    assert tuple(out.shape) == (2, 21)
    np.testing.assert_array_equal(out.numpy(), jax_greedy)


def test_torch_input_and_top_k_one_are_greedy(models, jax_greedy):
    _, pm = models
    out = pm.generate(torch.from_numpy(IDS).long(), max_length=16,
                      decode_strategy="sampling", top_k=1)
    np.testing.assert_array_equal(out.numpy(), jax_greedy)


@pytest.mark.parametrize("use_cache", MODES, ids=["static", "concat",
                                                  "recompute"])
def test_greedy_draws_nothing_from_the_generator(models, use_cache):
    _, pm = models
    state = tgen.default_generator("cpu").get_state()
    pm.generate(IDS, max_length=9, use_cache=use_cache)
    assert torch.equal(tgen.default_generator("cpu").get_state(), state)


@pytest.mark.parametrize("top_k,temperature", [(5, 0.8), (0, 1.3)])
def test_seeded_sampling_static_equals_concat(models, top_k, temperature):
    _, pm = models
    kw = dict(max_length=16, decode_strategy="sampling", top_k=top_k,
              temperature=temperature)
    paddle_tpu_torch.seed(11)
    fast = pm.generate(IDS[:1], use_cache=True, **kw)
    paddle_tpu_torch.seed(11)
    concat = pm.generate(IDS[:1], use_cache="concat", **kw)
    paddle_tpu_torch.seed(12)
    other = pm.generate(IDS[:1], use_cache=True, **kw)
    np.testing.assert_array_equal(fast.numpy(), concat.numpy())
    assert not torch.equal(fast, other)      # the seed reaches the draws
    if top_k:
        # every sampled token is among the top k of its step's logits
        with torch.no_grad():
            logits = pm(fast.long())[0, 4:-1]
        top = torch.topk(logits, top_k).indices
        assert (top == fast[0, 5:, None].long()).any(-1).all()


@pytest.mark.parametrize("use_cache", MODES, ids=["static", "concat",
                                                  "recompute"])
def test_eos_early_exit_matches_jax(models, jax_greedy, use_cache):
    jm, pm = models
    eos = int(jax_greedy[0, 6])       # a token the greedy path emits
    ref = _jax(jm, IDS, max_length=24, eos_token_id=eos)
    out = pm.generate(IDS, max_length=24, eos_token_id=eos,
                      use_cache=use_cache).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    for r in range(out.shape[0]):
        hit = np.where(out[r, 5:] == eos)[0]
        if hit.size:
            assert (out[r, 5 + hit[0]:] == eos).all()


def test_eos_trims_when_every_row_stops(models):
    """A one-row batch stops at its first eos: the output ends there."""
    jm, pm = models
    probe = pm.generate(IDS[:1], max_length=12).numpy()
    eos = int(probe[0, 7])
    ref = _jax(jm, IDS[:1], max_length=30, eos_token_id=eos)
    for use_cache in MODES:
        out = pm.generate(IDS[:1], max_length=30, eos_token_id=eos,
                          use_cache=use_cache).numpy()
        np.testing.assert_array_equal(out, ref)
        assert out[0, -1] == eos and out.shape[1] < 35


def _no_static(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the static lane was taken")
    monkeypatch.setattr(tgpt, "_gpt_generate_static", refuse)


def test_too_long_falls_back_to_concat(models, monkeypatch):
    """``L + max_length`` one past the position table: the concat cache
    (whose last input token still sits at the last position)."""
    jm, pm = models
    ids = np.random.default_rng(3).integers(0, 64, (1, 41)).astype(np.int32)
    ref = _jax(jm, ids, max_length=24)
    _no_static(monkeypatch)
    out = pm.generate(ids, max_length=24)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("use_cache", MODES, ids=["static", "concat",
                                                  "recompute"])
def test_past_the_position_table_matches_jax(models, monkeypatch,
                                             use_cache):
    """``L + max_length`` three past the position table: the last tokens'
    positions are past it. The JAX package's gather embeds them as NaN,
    and so does the port, so the tokens are the JAX package's in every
    mode (``True`` falls back to the concat cache)."""
    jm, pm = models
    ids = np.random.default_rng(3).integers(0, 64, (2, 41)).astype(np.int32)
    ref = _jax(jm, ids, max_length=27, use_cache=use_cache)
    _no_static(monkeypatch)
    out = pm.generate(ids, max_length=27, use_cache=use_cache)
    assert tuple(out.shape) == (2, 68)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_dropout_in_train_mode_falls_back_to_concat(monkeypatch):
    cfg = dict(MODEL, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    pm = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=1).train()
    _no_static(monkeypatch)
    out = pm.generate(IDS, max_length=6)
    assert tuple(out.shape) == (2, 11)
    assert pm.training


def test_train_mode_without_dropout_takes_the_static_lane(models,
                                                          monkeypatch):
    _, pm = models
    taken = []
    real = tgpt._gpt_generate_static

    def spy(*a, **kw):
        taken.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tgpt, "_gpt_generate_static", spy)
    pm.train()
    try:
        pm.generate(IDS, max_length=4)
    finally:
        pm.eval()
    assert taken == [1]


def test_decode_strategy_error(models):
    _, pm = models
    with pytest.raises(ValueError, match="beam"):
        pm.generate(IDS, decode_strategy="beam_search")


def test_trim_and_pow2_helpers():
    gen = np.array([[1, 7, 7], [7, 7, 7]])
    assert tgpt._trim_generated(gen, 7) == 2
    assert tgpt._trim_generated(gen, None) == 3
    assert tgpt._trim_generated(np.array([[1, 2], [7, 7]]), 7) == 2
    assert [tgpt._next_pow2(n) for n in (1, 2, 5, 64, 65)] == \
        [1, 2, 8, 64, 128]
    assert tgpt._EOS_CHECK_EVERY == 8
