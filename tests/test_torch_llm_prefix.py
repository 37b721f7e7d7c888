"""The port's prefix K/V reuse on the static-slot layout against the JAX
package's: ``chain_hashes`` byte for byte, ``PrefixStore`` over one
sequence of operations, ``StaticKVCache.host_slot_kv``, the prefix insert
and the tail prefill (K/V rows, lengths and tokens at mixed offsets, the
tail's logits against a full prefill's), and the slot ``LLMEngine`` with
``prefix_cache=True``: the JAX engine's tokens and ``prefix.*`` counters,
the tokens of the port's own engine with reuse off, an explicit
``prefix_store=`` shared between engines, and every exit unpinning.
Tiny model: vocab 64, hidden 32, 2 layers, 4 heads, 4-token blocks."""
import time

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
from paddle_tpu.serving.llm import prefix as jprefix  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import DeadlineExceeded  # noqa: E402
from paddle_tpu_torch.serving.llm import (ContinuousBatcher,  # noqa: E402
                                          GenerationRequest,
                                          GPTStaticDecoder, LLMEngine,
                                          LLMEngineConfig, PrefixStore,
                                          chain_hashes)
from paddle_tpu_torch.serving.llm.decode import (SamplingParams,  # noqa: E402
                                                 pack_sampling,
                                                 tail_forward)
from paddle_tpu_torch.serving.request import Deadline  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, prefix_cache=True, prefix_block=4,
              seed=3)
#: 20 and 24 share a 16-token head; 33 re-sends 24's first 20 tokens
PROMPT_LENS = (5, 12, 20, 24, 33)
TOL = dict(rtol=1e-5, atol=1e-5)


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
    rng = np.random.RandomState(7)
    out = [rng.randint(0, MODEL["vocab_size"], size=n).astype(np.int32)
           for n in PROMPT_LENS]
    out[3][:16] = out[2][:16]
    out[4][:20] = out[3][:20]
    return out


def _serve_twice(engine, new=10):
    """Every prompt twice, one request at a time (so both packages see
    the same store state at each admission); returns both passes."""
    try:
        return [[engine.submit(p, max_new_tokens=new).result(120)["tokens"]
                 for p in _prompts()] for _ in range(2)]
    finally:
        engine.drain(timeout=60)


# -- the store ----------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(40, 16), (33, 4), (7, 8), (16, 1)])
def test_chain_hashes_byte_equal_jax(n, block):
    toks = np.random.default_rng(n).integers(0, 50304, n).astype(np.int32)
    got = chain_hashes(toks, block)
    assert got == jprefix.chain_hashes(toks, block)
    assert len(got) == n // block
    assert chain_hashes(toks.tolist(), block) == got


def _store_ops(store, sig):
    """One sequence of inserts, lookups, unpins and evictions on a store
    of either package; returns what each step saw."""
    rng = np.random.RandomState(3)
    toks = [rng.randint(0, 64, size=16).astype(np.int32) for _ in range(3)]

    def kv(n, seed):
        k = np.random.default_rng(seed).standard_normal(
            (1, n, 1, 4)).astype(np.float32)
        return k, k + 0.5

    seen = []
    pinned = store.insert(toks[0], *kv(16, 0), sig)        # stays pinned
    mid = store.insert(toks[1], *kv(16, 1), sig)
    store.unpin(mid)
    dup = store.insert(toks[1], *kv(16, 1), sig)            # dedup: pins
    seen.append((dup is mid, store.stats()))
    store.unpin(dup)
    probe = np.concatenate([toks[0][:8], toks[2][:6]])
    hit, n = store.lookup(probe, probe.size - 1, sig)       # 8 of 16
    seen.append((hit is pinned, n))
    store.unpin(hit)
    seen.append(store.lookup(toks[0], 12, sig)[1])          # capped at 12
    store.unpin(pinned)
    seen.append(store.lookup(toks[0], 16, (2, 1, 4, "float32"))[1])
    third = store.insert(toks[2], *kv(16, 2), sig)          # evicts mid
    store.unpin(third)
    seen.append([store.lookup(t, 16, sig)[1] for t in toks])
    seen.append(store.stats())
    seen.append(store.insert(toks[0][:3], *kv(3, 3), sig))  # under a block
    return seen


def test_prefix_store_mirrors_jax_on_one_operation_sequence():
    """Lookup, insert, dedup, the reuse cap, a signature miss, LRU
    eviction of the unpinned middle entry (the pinned oldest survives)
    and the counters: the same results and stats in both packages."""
    sig = (1, 1, 4, "float32")
    kw = dict(capacity_bytes=1100, block_tokens=4)
    jreg, treg = JStatRegistry(), StatRegistry()
    jstore = jprefix.PrefixStore(registry=jreg, **kw)
    tstore = PrefixStore(registry=treg, **kw)
    assert _store_ops(tstore, sig) == _store_ops(jstore, sig)
    pre = "serving.llm.prefix."
    assert treg.stats_with_prefix(pre) == jreg.stats_with_prefix(pre)
    assert tstore.stats()["pinned"] == jstore.stats()["pinned"] == 2


def test_prefix_store_validates_its_inputs():
    with pytest.raises(ValueError, match="block_tokens"):
        PrefixStore(block_tokens=0)
    store = PrefixStore(block_tokens=4)
    k = np.zeros((1, 4, 1, 4), np.float32)
    with pytest.raises(ValueError, match="rows"):
        store.insert(np.arange(8, dtype=np.int32), k, k, (1, 1, 4, "f"))
    assert "entries=0" in repr(store) and len(store) == 0


# -- the cache and the programs ----------------------------------------------

def _decoders(models):
    jm, pm = models
    return jdec.GPTStaticDecoder(jm, max_top_k=0), GPTStaticDecoder(
        pm, max_top_k=0)


def _same_random_caches(jd, td, slots, max_seq, seed):
    jkv, tkv = jd.new_kv(slots, max_seq), td.new_kv(slots, max_seq)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(tuple(tkv.k.shape)).astype(np.float32)
    v = rng.standard_normal(tuple(tkv.v.shape)).astype(np.float32)
    tkv.k.copy_(torch.from_numpy(k))
    tkv.v.copy_(torch.from_numpy(v))
    jkv.k, jkv.v = jnp.asarray(k), jnp.asarray(v)
    return jkv, tkv


@pytest.mark.parametrize("starts", [(0, 5), (3, 12), (20, 28)])
def test_write_prompt_kv_at_matches_jax(starts):
    """The offset writer at per-request starts, one past the row's end
    (its start clamps, as ``dynamic_update_slice``'s does)."""
    from paddle_tpu.serving.llm import kvcache as jkv
    from paddle_tpu_torch.serving.llm import kvcache as tkv
    rng = np.random.default_rng(sum(starts))
    buf = rng.standard_normal((3, 2, 32, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 2, 8, 2, 4)).astype(np.float32)
    slots = np.array([2, 0], np.int32)
    jk, jv = jkv.write_prompt_kv_at(
        jnp.asarray(buf), jnp.asarray(buf + 1), jnp.asarray(new),
        jnp.asarray(new - 1), jnp.asarray(slots),
        jnp.asarray(starts, jnp.int32))
    tk, tv = torch.from_numpy(buf.copy()), torch.from_numpy(buf + 1)
    tkv.write_prompt_kv_at(tk, tv, torch.from_numpy(new),
                           torch.from_numpy(new - 1), slots,
                           torch.tensor(starts))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("positions", [(0, 9, 29), (4, 30, 40)])
def test_append_tokens_kv_matches_jax(positions):
    """The verify step's writer: T = 3 rows a slot at each slot's
    position, clamped at the row's end, through the layer view."""
    from paddle_tpu.serving.llm import kvcache as jkv
    from paddle_tpu_torch.serving.llm import kvcache as tkv
    rng = np.random.default_rng(positions[1])
    buf = rng.standard_normal((3, 2, 32, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    pos = np.array(positions, np.int32)
    jk, jv = jkv.append_tokens_kv(
        jnp.asarray(buf[:, 1]), jnp.asarray(buf[:, 1] + 1),
        jnp.asarray(new), jnp.asarray(new - 1), jnp.asarray(pos))
    tk, tv = torch.from_numpy(buf.copy()), torch.from_numpy(buf + 1)
    tkv.append_tokens_kv(tkv.kv_layer_view(tk, 1), tkv.kv_layer_view(tv, 1),
                         torch.from_numpy(new), torch.from_numpy(new - 1),
                         torch.from_numpy(pos))
    np.testing.assert_array_equal(tk[:, 1].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:, 1].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[:, 0].numpy(), buf[:, 0])


def test_host_slot_kv_and_insert_prefix_match_jax(models):
    jd, td = _decoders(models)
    jkv, tkv = _same_random_caches(jd, td, 3, 32, 1)
    for slot, n in ((0, 1), (2, 12), (1, 32)):
        jk, jv = jkv.host_slot_kv(slot, n)
        tk, tv = tkv.host_slot_kv(slot, n)
        assert tk.shape == (2, n, 4, 8) and tk.dtype == np.float32
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tv, jv)
    with pytest.raises(ValueError, match="slot"):
        tkv.host_slot_kv(3, 4)
    with pytest.raises(ValueError, match="n=0"):
        tkv.host_slot_kv(0, 0)
    k_pre, v_pre = tkv.host_slot_kv(2, 12)
    jd.insert_prefix(jkv, k_pre, v_pre, 0)
    td.insert_prefix(tkv, k_pre, v_pre, 0)
    np.testing.assert_array_equal(tkv.k.numpy(), np.asarray(jkv.k))
    np.testing.assert_array_equal(tkv.v.numpy(), np.asarray(jkv.v))
    assert td.insert_prefix_fn(12).trace_counter["traces"] == 1
    assert td.prefix_sig(tkv) == jd.prefix_sig(jkv)


def test_tail_prefill_at_mixed_offsets_matches_jax(models):
    """Two tails in one bucket of 8 (5 and 8 real tokens) at offsets 4 and
    12 into slots 2 and 0 of equal random caches: the K/V buffers, the
    lengths and the first tokens agree; one program serves both offsets."""
    jd, td = _decoders(models)
    jkv, tkv = _same_random_caches(jd, td, 4, 32, 2)
    toks = np.random.default_rng(3).integers(0, 64, (2, 8)).astype(np.int32)
    lens = np.array([5, 8], np.int32)
    starts = np.array([4, 12], np.int32)
    slots = np.array([2, 0], np.int32)
    jn, _ = jd.tail_prefill(
        jkv, jd.params(), jnp.asarray(toks), jnp.asarray(lens),
        jnp.asarray(starts), jnp.asarray(slots), jnp.zeros((4,), bool),
        jdec.pack_sampling([jdec.SamplingParams()] * 2),
        jax.random.PRNGKey(0))
    tn, tfin = td.tail_prefill(
        tkv, td.params(), torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(starts), torch.from_numpy(slots),
        torch.zeros(4, dtype=torch.bool),
        pack_sampling([SamplingParams()] * 2, "cpu"), None)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tkv.host_lengths().tolist() == np.asarray(jkv.lengths).tolist()
    assert tkv.host_lengths().tolist() == [20, 0, 9, 0]
    np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k), **TOL)
    np.testing.assert_allclose(tkv.v.numpy(), np.asarray(jkv.v), **TOL)
    assert td.tail_prefill_fn(2, 8).trace_counter["traces"] == 1
    assert not tfin.any()


def _jax_prefill_logits(spec, params, tokens):
    lp = tokens.shape[1]
    h = params["tok"][tokens] + params["pos"][jnp.arange(lp)][None]
    mask = jnp.triu(jnp.full((lp, lp), -1e9, h.dtype), 1)[None, None]
    for layer in params["layers"]:
        h, _, _ = jdec._block_prefill(spec, layer, h, mask,
                                      1.0 / np.sqrt(spec.head_dim))
    h = jdec._layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    return np.asarray(h[:, -1] @ params["tok"].T)


@pytest.mark.parametrize("n,reuse", [(20, 16), (13, 4), (9, 8)])
def test_tail_logits_equal_a_full_prefill_of_jax(models, n, reuse):
    """A prompt's head prefilled, exported and inserted into another slot,
    then its tail through ``tail_forward``: the last token's logits equal
    the JAX package's full prefill of the whole prompt at 1e-5."""
    jd, td = _decoders(models)
    prompt = np.random.default_rng(n).integers(0, 64, n).astype(np.int32)
    kv, params = td.new_kv(2, 32), td.params()
    samp = pack_sampling([SamplingParams()], "cpu")
    td.prefill(kv, params, torch.from_numpy(prompt[None, :reuse]),
               torch.tensor([reuse], dtype=torch.int32),
               torch.tensor([1], dtype=torch.int32),
               torch.zeros(2, dtype=torch.bool), samp, None)
    td.insert_prefix(kv, *kv.host_slot_kv(1, reuse), 0)
    slot0 = torch.tensor([0])
    tail = torch.from_numpy(prompt[None, reuse:])

    def write(li, k, v):
        kv.k[0, li, reuse:n] = k[0]
        kv.v[0, li, reuse:n] = v[0]

    with torch.no_grad():
        lraw, k_tail, _ = tail_forward(
            td.spec, params, tail, torch.tensor([n - reuse]),
            torch.tensor([reuse]), kv.max_seq, write,
            lambda li: (kv.k[slot0, li], kv.v[slot0, li]))
    ref = _jax_prefill_logits(jd.spec, jd.params(), jnp.asarray(prompt[None]))
    np.testing.assert_allclose(lraw.numpy(), ref, **TOL)
    assert tuple(k_tail.shape) == (1, 2, n - reuse, 4, 8)


# -- the engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(models):
    reg = JStatRegistry()
    eng = JLLMEngine(models[0], JConfig(**ENGINE), registry=reg)
    return _serve_twice(eng), reg, eng.prefix_store.stats()


@pytest.fixture(scope="module")
def port_run(models):
    reg = StatRegistry()
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE), registry=reg)
    return _serve_twice(eng), reg, eng


def test_prefix_engine_gives_the_jax_engines_tokens(jax_run, port_run):
    assert port_run[0] == jax_run[0]
    assert port_run[0][0] == port_run[0][1]


def test_prefix_engine_counters_equal_jax(jax_run, port_run):
    pre = "serving.llm.prefix."
    got = port_run[1].stats_with_prefix(pre)
    assert got == jax_run[1].stats_with_prefix(pre)
    assert got[pre + "hits"] >= 5 and got[pre + "reused_tokens"] >= 60
    stats = port_run[2].stats()["prefix_store"]
    assert stats == jax_run[2]
    assert stats["pinned"] == 0 and stats["bytes_copied"] > 0
    hists = port_run[1].histograms_with_prefix(pre)
    assert hists[pre + "insert_ms"]["count"] == got[pre + "hits"]
    assert hists[pre + "export_ms"]["count"] == got[pre + "inserts"]


def test_prefix_engine_equals_the_engine_without_reuse(models, port_run):
    eng = LLMEngine(models[1], LLMEngineConfig(
        **dict(ENGINE, prefix_cache=False)))
    assert eng.prefix_store is None
    off = _serve_twice(eng)
    assert off == port_run[0]
    assert eng.stats()["prefix_store"] is None


def test_explicit_store_shared_between_engines(models):
    """An entry one engine (max_seq 64) exported serves another (max_seq
    32) through the same store, given as ``prefix_store=`` with
    ``prefix_cache`` off, as the JAX package's cross-engine test does."""
    _, pm = models
    store = PrefixStore(registry=StatRegistry())
    prompt = _prompts()[3]                   # 24 tokens, 16-token blocks
    toks = []
    for max_seq in (64, 32):
        reg = StatRegistry()
        eng = LLMEngine(pm, LLMEngineConfig(num_slots=2, max_seq=max_seq,
                                            warmup=False),
                        registry=reg, prefix_store=store)
        assert eng.prefix_store is store
        try:
            toks.append(eng.submit(prompt, max_new_tokens=4)
                        .result(60)["tokens"])
        finally:
            eng.drain(timeout=60)
    assert toks[0] == toks[1]
    assert reg.get("serving.llm.prefix.reused_tokens") == 16
    assert store.stats()["entries"] == 1 and store.stats()["pinned"] == 0


def test_deadline_eviction_unpins_and_keeps_the_entry(models):
    _, pm = models
    reg = StatRegistry()
    store = PrefixStore(registry=reg)
    batcher = ContinuousBatcher(
        GPTStaticDecoder(pm), LLMEngineConfig(num_slots=2, max_seq=64,
                                              warmup=False),
        reg, prefix_store=store)
    prompt = _prompts()[3]
    seed = GenerationRequest(prompt, SamplingParams(max_new_tokens=2))
    batcher.admit(seed)                      # a miss: exported, pinned
    assert store.stats()["pinned"] == 1
    while batcher.active:
        batcher.tick()
    assert seed.finish_reason == "length" and store.stats()["pinned"] == 0
    doomed = GenerationRequest(prompt, SamplingParams(max_new_tokens=50),
                               deadline=Deadline(0.03))
    batcher.admit(doomed)                    # a hit: pinned again
    assert store.stats()["pinned"] == 1
    time.sleep(0.05)
    batcher.tick()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=5)
    assert store.stats()["pinned"] == 0 and store.stats()["entries"] == 1
    aborted = GenerationRequest(prompt, SamplingParams(max_new_tokens=50))
    batcher.admit(aborted)
    batcher.abort_all(lambda r: RuntimeError("abort"))
    assert store.stats()["pinned"] == 0 and batcher.active == 0
