"""The port's static-slot decode plane against the JAX package's:
``StaticKVCache`` and its writers, the prefill and decode-step programs
of ``GPTStaticDecoder`` (K/V buffers, lengths and logits at 1e-5), and
the default ``LLMEngine`` (``kv_layout="slot"``), whose greedy tokens must
equal the JAX package's slot engine and the port's paged engine, on the
flagship config (vocab 256, hidden 128, 2 layers, 4 heads, max_seq 64).

The JAX package's trace-count tests (one decode trace across occupancy
changes, prefill traces bounded by the buckets) have their counterparts
in ``tests/test_torch_llm_compile.py``."""
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
from paddle_tpu.serving.llm import kvcache as jkv  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import (DeadlineExceeded,  # noqa: E402
                                      EngineDraining)
from paddle_tpu_torch.serving.llm import (GPTStaticDecoder,  # noqa: E402
                                          LLMEngine, LLMEngineConfig,
                                          StaticKVCache)
from paddle_tpu_torch.serving.llm import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving.llm.decode import (SamplingParams,  # noqa: E402
                                                 pack_sampling,
                                                 prefill_forward)
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder  # noqa: E402

MODEL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
#: default prefill buckets (8, 16, 32, 64), so prompts up to 63 tokens
ENGINE = dict(num_slots=4, max_seq=64, seed=3)
#: (prompt length, new tokens): bucket edges, past the 16-token bucket,
#: and generation that reaches max_seq
CASES = [(4, 8), (8, 8), (16, 8), (17, 8), (30, 8), (56, 8), (60, 8),
         (63, 8), (1, 63), (12, 52)]
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
    rng = np.random.default_rng(42)
    return [rng.integers(0, MODEL["vocab_size"], n).tolist()
            for n, _ in CASES]


def _serve(engine, prompts=None):
    prompts = _prompts() if prompts is None else prompts
    try:
        reqs = [engine.submit(p, max_new_tokens=m)
                for p, (_, m) in zip(prompts, CASES)]
        return [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        engine.drain(timeout=60)


@pytest.fixture(scope="module")
def jax_tokens(models):
    eng = JLLMEngine(models[0], JConfig(**ENGINE), registry=JStatRegistry())
    assert eng.config.kv_layout == "slot"
    return _serve(eng)


@pytest.fixture(scope="module")
def slot_engine(models):
    """The default engine (no kv_layout given) on the port's model."""
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE))
    stats = eng.stats()
    return eng, stats, _serve(eng)


@pytest.fixture(scope="module")
def paged_tokens(models):
    return _serve(LLMEngine(models[1], LLMEngineConfig(
        **ENGINE, kv_layout="paged", page_size=4,
        paged_attn_impl="gather")))


# -- StaticKVCache ------------------------------------------------------------

def test_cache_alloc_free_reset_and_double_free_guard():
    kv = StaticKVCache(num_slots=3, num_layers=2, max_seq=8, num_heads=2,
                       head_dim=4, device="cpu")
    assert kv.free_slots == 3 and kv.k.shape == (3, 2, 8, 2, 4)
    a, b = kv.alloc(), kv.alloc()
    assert (a, b) == (0, 1) and kv.active_slots == (0, 1)
    kv.free(a)
    assert kv.alloc() == 0                 # lowest free slot first
    kv.free(0)
    with pytest.raises(ValueError, match="double free"):
        kv.free(0)
    with pytest.raises(ValueError):
        kv.free(5)
    kv.alloc()
    kv.alloc()
    with pytest.raises(tkv.SlotsExhausted):
        kv.alloc()
    kv.lengths.fill_(5)
    kv.reset()
    assert kv.free_slots == 3 and not kv.active_slots
    assert kv.host_lengths().tolist() == [0, 0, 0]
    assert kv.kv_bytes() == 2 * 3 * 2 * 8 * 2 * 4 * 4
    assert "slots=3" in repr(kv)


@pytest.mark.parametrize("kw,item", [
    (dict(kv_dtype="int8"), "A7"), (dict(mesh=object()), "A10")],
    ids=["int8", "mesh"])
def test_cache_later_slice_knobs_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        StaticKVCache(2, 1, 8, 1, 4, device="cpu", **kw)


def test_cache_prefix_export_raises_naming_a6():
    kv = StaticKVCache(2, 1, 8, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        kv.host_slot_kv(0, 4)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("positions", [[0, 3, 5], [7, 8, 30]],
                         ids=["inside", "at_and_past_max_seq"])
def test_append_token_kv_matches_jax(positions):
    """Positions at and past ``max_seq`` (free slots keep advancing) write
    the last row, as ``lax.dynamic_update_slice`` clamps."""
    kb, vb = _rand(0, 3, 8, 2, 4), _rand(1, 3, 8, 2, 4)
    kn, vn = _rand(2, 3, 2, 4), _rand(3, 3, 2, 4)
    pos = np.asarray(positions, np.int32)
    jk, jv = jkv.append_token_kv(jnp.asarray(kb), jnp.asarray(vb),
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos))
    tk, tv = torch.from_numpy(kb.copy()), torch.from_numpy(vb.copy())
    out = tkv.append_token_kv(tk, tv, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pos))
    assert out[0] is tk                                 # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_append_token_kv_writes_through_the_layer_view():
    buf = torch.zeros(2, 3, 8, 1, 2)
    view = tkv.kv_layer_view(buf, 1)
    tkv.append_token_kv(view, view, torch.ones(2, 1, 2),
                        torch.ones(2, 1, 2), torch.tensor([2, 9]))
    assert buf[0, 1, 2].sum() == 2 and buf[1, 1, 7].sum() == 2
    assert buf.sum() == 4


def test_write_prompt_kv_matches_jax():
    buf_k, buf_v = _rand(4, 3, 2, 8, 1, 2), _rand(5, 3, 2, 8, 1, 2)
    kp, vp = _rand(6, 2, 2, 4, 1, 2), _rand(7, 2, 2, 4, 1, 2)
    slots = np.asarray([2, 0], np.int32)
    jk, jv = jkv.write_prompt_kv(jnp.asarray(buf_k), jnp.asarray(buf_v),
                                 jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(slots))
    tk, tv = torch.from_numpy(buf_k.copy()), torch.from_numpy(buf_v.copy())
    tkv.write_prompt_kv(tk, tv, torch.from_numpy(kp), torch.from_numpy(vp),
                        torch.from_numpy(slots))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_valid_mask_matches_jax():
    lengths = np.asarray([0, 2, 3, 9], np.int32)
    ref = np.asarray(jkv.valid_mask(jnp.asarray(lengths), 4))
    out = tkv.valid_mask(torch.from_numpy(lengths), 4).numpy()
    assert out.shape == (4, 1, 1, 4)
    np.testing.assert_array_equal(out, ref)


# -- the programs against the JAX package's -----------------------------------

def _jax_decode_logits(spec, params, kbuf, vbuf, lengths, last):
    """The forward half of the JAX package's decode step
    (``build_decode_step``), which returns no logits of its own."""
    scale = 1.0 / np.sqrt(spec.head_dim)
    posc = jnp.clip(lengths, 0, spec.max_position_embeddings - 1)
    h = params["tok"][last] + params["pos"][posc]
    mask = jkv.valid_mask(lengths, kbuf.shape[2], h.dtype)
    for li, lp in enumerate(params["layers"]):
        h, _, _ = jdec._block_decode(spec, lp, h, kbuf[:, li], vbuf[:, li],
                                     lengths, mask, scale)
    h = jdec._layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    return np.asarray(h @ params["tok"].T)


def _jax_prefill_logits(spec, params, tokens, true_lens):
    """The logits the JAX package's prefill (``build_prefill_fn``)
    samples its first token from."""
    lp = tokens.shape[1]
    h = params["tok"][tokens] + params["pos"][jnp.arange(lp)][None]
    mask = jnp.triu(jnp.full((lp, lp), -1e9, h.dtype), 1)[None, None]
    for layer in params["layers"]:
        h, _, _ = jdec._block_prefill(spec, layer, h, mask,
                                      1.0 / np.sqrt(spec.head_dim))
    h = jdec._layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    last = h[jnp.arange(tokens.shape[0]), true_lens - 1]
    return np.asarray(last @ params["tok"].T)


def test_prefill_logits_match_jax(models):
    """Two right-padded prompts in one bucket of 16."""
    jm, pm = models
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9] = np.arange(9) * 7 % 256
    toks[1] = np.arange(16) * 13 % 256
    lens = np.asarray([9, 16], np.int32)
    td = GPTStaticDecoder(pm)
    ref = _jax_prefill_logits(td.spec, jdec.GPTStaticDecoder(jm).params(),
                              jnp.asarray(toks), jnp.asarray(lens))
    with torch.no_grad():
        lraw, k_new, _ = prefill_forward(td.spec, td.params(),
                                         torch.from_numpy(toks),
                                         torch.from_numpy(lens))
    assert tuple(k_new.shape) == (2, 2, 16, 4, 32)
    np.testing.assert_allclose(lraw.numpy(), ref, **TOL)


def test_prefill_and_decode_match_jax_decoder(models):
    """Prefill 3 prompts (one past its bucket's middle, one whole bucket)
    into slots 2, 0, 3 of both packages' decoders, then 3 decode steps,
    one with a free slot past ``max_seq``: the K/V buffers, the lengths,
    the tokens and the decode-step logits agree at 1e-5."""
    jm, pm = models
    jd = jdec.GPTStaticDecoder(jm, max_top_k=0)
    td = GPTStaticDecoder(pm, max_top_k=0)
    max_seq = 32
    jkvc, tkvc = jd.new_kv(4, max_seq), td.new_kv(4, max_seq)
    jp, tp = jd.params(), td.params()
    jsv = jdec.pack_sampling([jdec.SamplingParams()] * 4)
    tsv = pack_sampling([SamplingParams()] * 4, "cpu")
    jfin = jnp.zeros((4,), jnp.bool_)
    tfin = torch.zeros(4, dtype=torch.bool)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(7)
    last = np.zeros(4, np.int32)
    for slot, n, lp in ((2, 5, 8), (0, 16, 16), (3, 11, 16)):
        toks = np.zeros((1, lp), np.int32)
        toks[0, :n] = rng.integers(0, 256, n)
        jsv1 = jdec.pack_sampling([jdec.SamplingParams()])
        jn, jfin = jd.prefill(jkvc, jp, jnp.asarray(toks),
                              jnp.asarray([n], jnp.int32),
                              jnp.asarray([slot], jnp.int32), jfin, jsv1,
                              key)
        tn, tfin = td.prefill(tkvc, tp, torch.from_numpy(toks),
                              torch.tensor([n], dtype=torch.int32),
                              torch.tensor([slot], dtype=torch.int32), tfin,
                              pack_sampling([SamplingParams()], "cpu"),
                              None)
        assert int(tn[0]) == int(np.asarray(jn)[0])
        last[slot] = int(tn[0])
    # a free slot (1) already past max_seq: every slot advances each tick
    tkvc.lengths[1] = max_seq + 3
    jkvc.lengths = jkvc.lengths.at[1].set(max_seq + 3)
    np.testing.assert_allclose(tkvc.k.numpy(), np.asarray(jkvc.k), **TOL)
    np.testing.assert_allclose(tkvc.v.numpy(), np.asarray(jkvc.v), **TOL)
    tlast, jlast = torch.from_numpy(last), jnp.asarray(last)
    for _ in range(3):
        ref = _jax_decode_logits(jd.spec, jp, jkvc.k, jkvc.v, jkvc.lengths,
                                 jlast)
        logits = td.decode_logits(tkvc, tp, tlast)
        np.testing.assert_allclose(logits.numpy(), ref, **TOL)
        jn, jfin = jd.decode_step(jkvc, jp, jfin, jlast, jsv, key)
        tn, tfin = td.decode_step(tkvc, tp, tfin, tlast, tsv, None)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert tkvc.host_lengths().tolist() == \
            np.asarray(jkvc.lengths).tolist()
        np.testing.assert_allclose(tkvc.k.numpy(), np.asarray(jkvc.k),
                                   **TOL)
        np.testing.assert_allclose(tkvc.v.numpy(), np.asarray(jkvc.v),
                                   **TOL)
        tlast, jlast = tn, jn


def test_decoder_knobs_of_later_slices_raise(models):
    _, pm = models
    dec = GPTStaticDecoder(pm)
    with pytest.raises(NotImplementedError, match="A6"):
        dec.tail_prefill()
    with pytest.raises(NotImplementedError, match="A6"):
        dec.insert_prefix()
    with pytest.raises(NotImplementedError, match="A10"):
        GPTStaticDecoder(pm, mesh=object())
    with pytest.raises(ValueError, match="positions"):
        dec.new_kv(2, 128)


def test_slot_logits_equal_paged_gather_logits(models):
    """One decode step's logits, slot lane against the paged gather lane,
    on the same 4 prefilled prompts."""
    _, pm = models
    sd, pd = GPTStaticDecoder(pm), GPTPagedDecoder(pm, page_size=4,
                                                   attn_impl="gather")
    skv, pkv = sd.new_kv(4, 64), pd.new_kv(4, 64)
    sp, pp = sd.params(), pd.params()
    fin = torch.zeros(4, dtype=torch.bool)
    samp = pack_sampling([SamplingParams()], "cpu")
    last = torch.zeros(4, dtype=torch.int32)
    rng = np.random.default_rng(9)
    for slot, n in enumerate((3, 17, 30, 9)):
        lp = 1 << (n - 1).bit_length()
        toks = torch.zeros(1, lp, dtype=torch.int32)
        toks[0, :n] = torch.from_numpy(rng.integers(0, 256, n))
        args = (toks, torch.tensor([n], dtype=torch.int32),
                torch.tensor([slot], dtype=torch.int32), fin, samp, None)
        skv.alloc()
        pkv.alloc()
        pkv.ensure_pages(slot, n + 1)
        nxt, _ = sd.prefill(skv, sp, *args)
        nxt2, _ = pd.prefill(pkv, pp, *args)
        assert int(nxt) == int(nxt2)
        last[slot] = nxt[0]
    ls = sd.decode_logits(skv, sp, last)
    lg = pd.decode_logits(pkv, pp, last, "gather")
    np.testing.assert_allclose(ls.numpy(), lg.numpy(), **TOL)
    assert skv.host_lengths().tolist() == [3, 17, 30, 9]   # not advanced


# -- the engine ---------------------------------------------------------------

def test_default_engine_is_the_slot_engine(slot_engine):
    eng, stats, _ = slot_engine
    assert isinstance(eng.decoder, GPTStaticDecoder)
    assert stats["kv_layout"] == "slot" and stats["pages"] is None
    # K and V: 4 slots x 2 layers x 64 rows x 4 heads x 32 x 4 bytes
    assert stats["kv_bytes"] == 2 * 4 * 2 * 64 * 4 * 32 * 4


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"p{n}_new{m}" for n, m in CASES])
def test_slot_engine_greedy_tokens_equal_jax(slot_engine, jax_tokens, case):
    tokens = slot_engine[2]
    n, m = CASES[case]
    assert tokens[case] == jax_tokens[case]
    assert len(tokens[case]) == min(m, ENGINE["max_seq"] - n)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"p{n}_new{m}" for n, m in CASES])
def test_slot_engine_equals_paged_engine(slot_engine, paged_tokens, case):
    assert slot_engine[2][case] == paged_tokens[case]


def _engine(pm, **kw):
    cfg = dict(num_slots=2, max_seq=16, prefill_buckets=(8,), seed=0)
    cfg.update(kw)
    return LLMEngine(pm, LLMEngineConfig(**cfg))


def test_free_slot_past_max_seq_then_reused(models):
    """Slot 1 stays free while slot 0 serves two 15-token requests: its
    length runs past max_seq (its writes clamp to the last row), and a
    request then prefilled into it gives ``generate``'s tokens."""
    _, pm = models
    eng = _engine(pm)
    try:
        for _ in range(2):
            eng.submit([5], max_new_tokens=15).result(timeout=60)
        assert eng._batcher.kv.host_lengths()[1] > 16
        a = eng.submit([1, 2, 3], max_new_tokens=10)
        b = eng.submit([7, 8], max_new_tokens=10)
        ta, tb = a.result(timeout=60)["tokens"], b.result(timeout=60)["tokens"]
    finally:
        eng.drain(timeout=60)
    ref = pm.generate(np.array([[7, 8]]), max_length=10).numpy()[0, 2:]
    assert tb == ref.tolist()
    ref = pm.generate(np.array([[1, 2, 3]]), max_length=10).numpy()[0, 3:]
    assert ta == ref.tolist()


def test_midstream_join_and_leave(models):
    _, pm = models
    eng = _engine(pm, num_slots=3, max_seq=64)
    try:
        long_req = eng.submit([1, 2, 3], max_new_tokens=40, stream=True)
        it = long_req.iter_tokens(timeout=60)
        first = [next(it) for _ in range(4)]
        short = eng.submit([4, 5], max_new_tokens=3).result(timeout=60)
        assert len(short["tokens"]) == 3
        assert short["finish_reason"] == "length"
        third = eng.submit([6], max_new_tokens=3).result(timeout=60)
        assert len(third["tokens"]) == 3
        rest = list(it)
        assert len(first) + len(rest) == 40
        assert long_req.result(timeout=60)["tokens"] == first + rest
    finally:
        eng.drain(timeout=60)


def test_eos_finishes_early_like_generate(models):
    _, pm = models
    probe = pm.generate(np.array([[1, 2, 3]]), max_length=4).numpy()[0, 3:]
    eos = int(probe[1])
    eng = _engine(pm, max_seq=64)
    try:
        out = eng.submit([1, 2, 3], max_new_tokens=30,
                         eos_token_id=eos).result(timeout=60)
    finally:
        eng.drain(timeout=60)
    assert out["finish_reason"] == "stop" and out["tokens"][-1] == eos
    ref = pm.generate(np.array([[1, 2, 3]]), max_length=30,
                      eos_token_id=eos).numpy()[0, 3:]
    assert out["tokens"] == ref.tolist()


def test_deadline_evicts_stalled_slot(models):
    _, pm = models
    eng = _engine(pm, max_seq=64)
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=60, deadline=0.010)
        with pytest.raises(DeadlineExceeded):
            req.result(timeout=60)
        t_end = time.monotonic() + 30
        while eng._batcher.active and time.monotonic() < t_end:
            time.sleep(0.01)
        assert eng._batcher.active == 0
        assert eng.registry.get("serving.llm.evicted_midstream", 0) >= 1
        ok = eng.submit([4, 5], max_new_tokens=2).result(timeout=60)
        assert len(ok["tokens"]) == 2
    finally:
        eng.drain(timeout=60)


def test_drain_finishes_inflight_and_queued(models):
    _, pm = models
    eng = _engine(pm, num_slots=1, max_seq=64)
    inflight = eng.submit([1, 2], max_new_tokens=30)
    queued = eng.submit([3, 4], max_new_tokens=5)
    eng.begin_drain()
    with pytest.raises(EngineDraining):
        eng.submit([5], max_new_tokens=1)
    eng.drain(timeout=60)
    assert eng._stopped.is_set()
    assert len(inflight.result(timeout=1)["tokens"]) == 30
    assert len(queued.result(timeout=1)["tokens"]) == 5
