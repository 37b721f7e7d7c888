"""The port's draft-model speculative decoding on the static-slot layout
against the JAX package's: ``GPTConfig.draft``, one spec step (the packed
``[S, k+2]`` output, both caches and the shared lengths), and the slot
``LLMEngine`` with ``spec_k > 0``: greedy tokens equal to the JAX spec
engine's and to the port's plain engine's, for the target as its own
draft and for a distinct 1-layer draft, the ``spec.*`` counters equal to
the JAX engine's, the fallback to the plain step near the row's end,
sampled slots emitting one token a tick, and the refusals. Tiny model:
vocab 64, hidden 32, 2 layers, 4 heads."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu.serving.llm import decode as jdec  # noqa: E402
from paddle_tpu.serving.llm import spec as jspec  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving.llm import (GPTSpecDecoder,  # noqa: E402
                                          GPTStaticDecoder, LLMEngine,
                                          LLMEngineConfig)
from paddle_tpu_torch.serving.llm.decode import (SamplingParams,  # noqa: E402
                                                 pack_sampling)

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, seed=3)
PROMPT_LENS = (5, 12, 20, 24, 33)
NEW = 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(cfg, seed):
    paddle.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**cfg), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()},
        "cpu"), strict=True)
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _pair(MODEL, 0)


@pytest.fixture(scope="module")
def drafts():
    """A distinct draft: the target's config drafted to 1 layer, from
    another seed (it proposes mostly wrong tokens)."""
    cfg = dataclasses.asdict(GPTConfig(**MODEL).draft(2, num_layers=1))
    return _pair(cfg, 1)


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, MODEL["vocab_size"], size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts=None, new=NEW, **kw):
    """One request at a time, so both packages tick the same slots in the
    same order."""
    prompts = _prompts() if prompts is None else prompts
    try:
        return [engine.submit(p, max_new_tokens=new, **kw)
                .result(120)["tokens"] for p in prompts]
    finally:
        engine.drain(timeout=60)


@pytest.fixture(scope="module")
def plain_tokens(models):
    return _serve(LLMEngine(models[1], LLMEngineConfig(**ENGINE)))


# -- the config and one step ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(scale=2), dict(scale=3),
                                dict(hidden_size=24, num_heads=5),
                                dict(num_layers=1)])
def test_gpt_config_draft_equals_jax(kw):
    cfg = dict(MODEL, num_heads=8)
    got = dataclasses.asdict(GPTConfig(**cfg).draft(**kw))
    ref = dataclasses.asdict(JGPTConfig(**cfg).draft(**kw))
    ref.pop("attn_blocks")
    assert got == ref
    big = GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                    num_heads=16).draft()
    assert (big.hidden_size, big.num_layers, big.num_heads) == (512, 6, 4)


@pytest.mark.parametrize("k", [2, 3])
def test_spec_step_matches_jax(models, drafts, k):
    """Three prompts prefilled into slots 2, 0, 3 of both caches of both
    packages, then three spec steps: the packed outputs, the new last
    tokens, the target and draft K/V and the lengths agree."""
    (jm, pm), (jdm, pdm) = models, drafts
    jd, td = jdec.GPTStaticDecoder(jm, max_top_k=0), GPTStaticDecoder(
        pm, max_top_k=0)
    js = jspec.GPTSpecDecoder(jd, jdm, k=k)
    ts = GPTSpecDecoder(td, pdm, k=k)
    jkv, tkv = jd.new_kv(4, 32), td.new_kv(4, 32)
    jkd = js.new_draft_kv(4, 32)
    tkd = ts.new_draft_kv(4, 32, lengths=tkv.lengths)
    assert tkd.lengths is tkv.lengths
    jp, tp, jpd, tpd = jd.params(), td.params(), js.draft_params(), \
        ts.draft_params()
    key = jax.random.PRNGKey(0)
    jfin, tfin = jnp.zeros((4,), bool), torch.zeros(4, dtype=torch.bool)
    rng = np.random.default_rng(k)
    last = np.zeros(4, np.int32)
    for slot, n in ((2, 5), (0, 11), (3, 16)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = rng.integers(0, 64, n)
        jsv1 = jdec.pack_sampling([jdec.SamplingParams()])
        tsv1 = pack_sampling([SamplingParams()], "cpu")
        args = (jnp.asarray(toks), jnp.asarray([n], jnp.int32),
                jnp.asarray([slot], jnp.int32))
        jn, jfin = jd.prefill(jkv, jp, *args, jfin, jsv1, key)
        js.draft_prefill(jkd, jpd, *args, jkv.lengths, jfin, jsv1, key)
        targs = (torch.from_numpy(toks), torch.tensor([n], dtype=torch.int32),
                 torch.tensor([slot], dtype=torch.int32))
        tn, tfin = td.prefill(tkv, tp, *targs, tfin, tsv1, None)
        ts.draft_prefill(tkd, tpd, *targs, tfin, tsv1)
        assert int(tn[0]) == int(np.asarray(jn)[0])
        last[slot] = int(tn[0])
    jsv = jdec.pack_sampling([jdec.SamplingParams()] * 4)
    tsv = pack_sampling([SamplingParams()] * 4, "cpu")
    jlast, tlast = jnp.asarray(last), torch.from_numpy(last)
    for _ in range(3):
        jfin, jlast, jout = js.step(jkv, jkd, jp, jpd, jfin, jlast, jsv, key)
        tfin, tlast, tout = ts.step(tkv, tkd, tp, tpd, tfin, tlast, tsv,
                                    None)
        assert tuple(tout.shape) == (4, k + 2)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
        assert tkv.host_lengths().tolist() == \
            np.asarray(jkv.lengths).tolist()
        for got, ref in ((tkv.k, jkv.k), (tkv.v, jkv.v), (tkd.k, jkd.k),
                         (tkd.v, jkd.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        tlast, tfin = tlast.clone(), tfin.clone()
    assert ts.spec_step_fn(4, 32).trace_counter["traces"] == 1


# -- the engine -----------------------------------------------------------------

def _spec_engines(models, draft_pair, k):
    jm, pm = models
    jdm, pdm = draft_pair
    jreg, treg = JStatRegistry(), StatRegistry()
    jeng = JLLMEngine(jm, JConfig(**ENGINE, spec_k=k), registry=jreg,
                      draft_model=jdm)
    teng = LLMEngine(pm, LLMEngineConfig(**ENGINE, spec_k=k), registry=treg,
                     draft_model=pdm)
    return (_serve(jeng), jreg), (_serve(teng), treg, teng)


@pytest.fixture(scope="module")
def self_draft(models):
    return _spec_engines(models, models, 2)


@pytest.fixture(scope="module")
def other_draft(models, drafts):
    return _spec_engines(models, drafts, 3)


_SPEC = ("serving.llm.spec.proposed", "serving.llm.spec.accepted",
         "serving.llm.spec.ticks", "serving.llm.spec.fallback_ticks",
         "serving.llm.spec.acceptance_rate", "serving.llm.tokens_generated")


@pytest.mark.parametrize("lane", ["self_draft", "other_draft"])
def test_spec_engine_tokens_equal_jax_and_plain(request, lane,
                                                plain_tokens):
    (jtoks, _), (ttoks, _, _) = request.getfixturevalue(lane)
    assert ttoks == jtoks
    assert ttoks == plain_tokens
    assert all(len(t) == NEW for t in ttoks)


@pytest.mark.parametrize("lane", ["self_draft", "other_draft"])
def test_spec_engine_counters_equal_jax(request, lane):
    (_, jreg), (_, treg, teng) = request.getfixturevalue(lane)
    assert [treg.get(n) for n in _SPEC] == [jreg.get(n) for n in _SPEC]
    rate = treg.get("serving.llm.spec.acceptance_rate")
    assert rate == 1.0 if lane == "self_draft" else rate < 0.5
    assert treg.get("serving.llm.spec.ticks") > 0
    stats = teng.stats()
    assert stats["spec_k"] == (2 if lane == "self_draft" else 3)
    assert stats["stats"]["serving.llm.warmup_spec_steps"] == 1


def test_spec_falls_back_near_the_rows_end(models):
    """A slot without room for k+1 candidate rows takes the plain step:
    the tokens stay the plain engine's and the fallback is counted, as in
    the JAX package."""
    jm, pm = models
    prompt = _prompts()[2]                   # 20 tokens; 12 more fill 32
    cfg = dict(num_slots=2, max_seq=32, warmup=False)
    plain = _serve(LLMEngine(pm, LLMEngineConfig(**cfg)), [prompt], new=12)
    treg, jreg = StatRegistry(), JStatRegistry()
    got = _serve(LLMEngine(pm, LLMEngineConfig(**cfg, spec_k=4),
                           registry=treg, draft_model=pm), [prompt], new=12)
    ref = _serve(JLLMEngine(jm, JConfig(**cfg, spec_k=4), registry=jreg,
                            draft_model=jm), [prompt], new=12)
    assert got == plain == ref
    assert treg.get("serving.llm.spec.fallback_ticks") > 0
    assert treg.get("serving.llm.spec.ticks") > 0
    assert [treg.get(n) for n in _SPEC] == [jreg.get(n) for n in _SPEC]
    assert treg.get("serving.llm.decode_ticks") == \
        treg.get("serving.llm.spec.fallback_ticks")


def test_sampled_slot_emits_one_token_a_tick(models):
    _, pm = models
    reg = StatRegistry()
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, spec_k=3), registry=reg,
                    draft_model=pm)
    toks = _serve(eng, _prompts()[:1], do_sample=True, temperature=0.8,
                  top_k=8)
    assert len(toks[0]) == NEW
    assert reg.get("serving.llm.spec.ticks") == NEW - 1
    assert reg.get("serving.llm.spec.proposed") == 0


def test_mixed_batch_keeps_the_greedy_slots_plain(models, plain_tokens):
    """Greedy and sampled requests in flight together: every greedy slot
    still gives the plain engine's tokens."""
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, spec_k=2),
                    draft_model=pm)
    prompts = _prompts()
    try:
        reqs = [eng.submit(p, max_new_tokens=NEW, do_sample=bool(i % 2),
                           temperature=0.9, top_k=5)
                for i, p in enumerate(prompts)]
        toks = [r.result(120)["tokens"] for r in reqs]
    finally:
        eng.drain(timeout=60)
    for i, t in enumerate(toks):
        assert len(t) == NEW
        if i % 2 == 0:
            assert t == plain_tokens[i]


def test_spec_refusals_follow_jax(models, drafts):
    _, pm = models
    with pytest.raises(ValueError, match="draft_model"):
        LLMEngine(pm, LLMEngineConfig(num_slots=2, max_seq=32, warmup=False,
                                      spec_k=2))
    other = GPTForCausalLM(GPTConfig(**dict(MODEL, vocab_size=80)),
                           device="cpu").eval()
    with pytest.raises(ValueError, match="vocab"):
        LLMEngine(pm, LLMEngineConfig(num_slots=2, max_seq=32, warmup=False,
                                      spec_k=2), draft_model=other)
    with pytest.raises(ValueError, match="k must be >= 1"):
        GPTSpecDecoder(GPTStaticDecoder(pm), drafts[1], k=0)
    with pytest.raises(ValueError, match="spec_k"):
        LLMEngineConfig(spec_k=-1)
