"""The port's paged LLMEngine against the JAX package's, on the flagship
config (vocab 256, hidden 128, 2 layers, 4 heads) with 4-token pages and
max_seq 64: greedy tokens must be exactly equal, and the port's kernel
lane must give the tokens of its gather lane."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.serving import RequestTooLarge  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig)
from paddle_tpu_torch.serving.llm.decode import (SamplingParams,  # noqa: E402
                                                 pack_sampling)
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder  # noqa: E402

MODEL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, kv_layout="paged", page_size=4,
              prefill_buckets=(8, 16), seed=3)
# prompts that cross a page boundary (4-token pages)
PROMPT_LENS = (5, 7, 10)


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


def _prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, MODEL["vocab_size"], n).tolist()
            for n in PROMPT_LENS]


def _serve(engine, prompts, **kw):
    try:
        reqs = [engine.submit(p, max_new_tokens=8, **kw) for p in prompts]
        return [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        engine.drain(timeout=60)


@pytest.fixture(scope="module")
def jax_tokens(models):
    jm, _ = models
    eng = JLLMEngine(jm, JConfig(**ENGINE, paged_attn_impl="gather"),
                     registry=JStatRegistry())
    return _serve(eng, _prompts())


@pytest.mark.parametrize("impl", ["kernel", "gather", "auto"])
def test_greedy_tokens_equal_jax(models, jax_tokens, impl):
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, paged_attn_impl=impl))
    assert eng.decoder.attn_impl == ("gather" if impl == "auto" else impl)
    before = tpa.paged_attention.launches
    tokens = _serve(eng, _prompts())
    assert tokens == jax_tokens
    assert all(len(t) == 8 for t in tokens)
    assert tpa.paged_attention.launches == before     # CPU: plain version


def test_jax_kernel_lane_agrees_on_one_request(models, jax_tokens):
    """The JAX engine's own Pallas kernel lane (interpret mode) on the
    shortest prompt gives the same tokens the port does."""
    jm, _ = models
    eng = JLLMEngine(jm, JConfig(**ENGINE, paged_attn_impl="kernel",
                                 warmup=False), registry=JStatRegistry())
    assert _serve(eng, _prompts()[:1]) == jax_tokens[:1]


def test_decode_logits_kernel_lane_matches_gather_lane(models):
    _, pm = models
    dec = GPTPagedDecoder(pm, page_size=4, attn_impl="kernel")
    kv = dec.new_kv(3, 64)
    params = dec.params()
    gen = torch.Generator().manual_seed(0)
    fin = torch.zeros(3, dtype=torch.bool)
    last = torch.zeros(3, dtype=torch.int32)
    for slot, p in enumerate(_prompts()):
        kv.alloc()
        kv.ensure_pages(slot, len(p) + 1)
        toks = torch.zeros(1, 16, dtype=torch.int32)
        toks[0, :len(p)] = torch.tensor(p)
        nxt, fin = dec.prefill(kv, params, toks,
                               torch.tensor([len(p)], dtype=torch.int32),
                               torch.tensor([slot], dtype=torch.int32), fin,
                               pack_sampling([SamplingParams()], "cpu"), gen)
        last[slot] = nxt[0]
    lk = dec.decode_logits(kv, params, last, "kernel")
    lg = dec.decode_logits(kv, params, last, "gather")
    torch.testing.assert_close(lk, lg, rtol=1e-5, atol=1e-5)
    assert kv.host_lengths().tolist() == [len(p) for p in _prompts()]


def test_sampling_is_seeded_and_respects_top_k(models):
    _, pm = models

    def run():
        eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, warmup=False))
        return _serve(eng, _prompts(), do_sample=True, temperature=0.8,
                      top_k=5)
    a, b = run(), run()
    assert a == b
    assert all(0 <= t < MODEL["vocab_size"] for seq in a for t in seq)


def test_eos_stops_and_stats(models, jax_tokens):
    _, pm = models
    eos = jax_tokens[0][2]
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, warmup=False))
    try:
        res = eng.submit(_prompts()[0], max_new_tokens=8,
                         eos_token_id=eos).result(timeout=60)
        stats = eng.stats()
    finally:
        eng.drain(timeout=60)
    assert res["finish_reason"] == "stop"
    assert res["tokens"] == jax_tokens[0][:jax_tokens[0].index(eos) + 1]
    assert stats["kv_layout"] == "paged" and stats["device"] == "cpu"
    # K and V arenas: (4 slots x 16 pages + trash) x 2 layers x 4 rows x
    # 4 heads x 32 dims, fp32
    assert stats["pages"]["kv_bytes"] == 2 * 65 * 2 * 4 * 4 * 32 * 4
    assert stats["stats"]["serving.llm.completed"] == 1


def test_streaming_and_oversize(models, jax_tokens):
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, warmup=False))
    try:
        req = eng.submit(_prompts()[1], max_new_tokens=8, stream=True)
        assert list(req.iter_tokens(timeout=60)) == jax_tokens[1]
        with pytest.raises(RequestTooLarge):
            eng.submit(list(range(17)))
    finally:
        eng.drain(timeout=60)


def test_small_pool_serves_every_request(models, jax_tokens):
    """16 pages, the minimum for one max_seq sequence, shared by 4 slots:
    admission on pages at current length still serves six requests with
    the JAX tokens."""
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**ENGINE, num_pages=16,
                                        warmup=False))
    try:
        toks = _serve(eng, _prompts() * 2)
    finally:
        eng.drain(timeout=60)
    assert toks == jax_tokens * 2
