"""The port's compile-once serving contract against the JAX package's
(``tests/test_llm_serving.py``'s ``TestSingleCompile`` and
``test_midstream_join_and_leave``), on both KV layouts, on the CPU: the
decoders hand out compiled programs through ``decode_fn``/``prefill_fn``
with a ``trace_counter``, ``LLMEngine`` takes ``cache=`` and exposes
``.cache``, and after warm-up neither the decode traces nor the
executable cache's misses move across occupancy changes, a request
joining and leaving mid-stream, or prefills within one bucket. On the
CPU a program runs its static-buffer program eagerly and counts a trace
at each KV cache's first sighting (``core/graphs.py``); the captured
graphs are held on the card (``tests/test_torch_cuda.py``). Also: the
compiled lane's greedy tokens equal the JAX package's engine tokens for
the same numpy weights, ``generate`` called twice traces once, and the
program's binding rules (per cache, the weights' addresses, static
inputs and outputs, release on eviction)."""
import gc

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
from paddle_tpu_torch import framework_io, seed  # noqa: E402
from paddle_tpu_torch.core import graphs  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import ExecutableCache, default_cache  # noqa: E402
from paddle_tpu_torch.serving.llm import (GPTStaticDecoder,  # noqa: E402
                                          LLMEngine, LLMEngineConfig)
from paddle_tpu_torch.serving.llm.decode import (SamplingParams,  # noqa: E402
                                                 get_decode_step,
                                                 pack_sampling)
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder  # noqa: E402

#: the JAX package's serving-test model (tests/test_llm_serving.py)
MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16), warmup=True)
LAYOUTS = {"slot": {}, "paged": {"kv_layout": "paged", "page_size": 4}}


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


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def engine(request, models):
    """One engine per layout for the module, on its own cache."""
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE,
                                               **LAYOUTS[request.param]),
                    cache=ExecutableCache())
    yield eng
    if not eng._stopped.is_set():
        eng.drain(timeout=60)


def _decode_fn(engine):
    return engine.decoder.decode_fn(engine.config.num_slots,
                                    engine.config.max_seq)


# -- the JAX package's TestSingleCompile ---------------------------------------

def test_one_decode_trace_across_occupancy_changes(engine):
    """After warm-up, 64+ tokens across 1-, 3- and 2-deep occupancy run
    through zero new decode traces and zero executable-cache misses."""
    fn = _decode_fn(engine)
    t0 = fn.trace_counter["traces"]
    m0 = engine.cache.stats()["misses"]
    assert t0 == 1     # warm-up traced it, once
    engine.submit([1, 2, 3], max_new_tokens=24).result(timeout=60)
    rs = [engine.submit([i + 1, i + 2], max_new_tokens=16)
          for i in range(3)]
    for r in rs:
        assert len(r.result(timeout=60)["tokens"]) == 16
    r2 = [engine.submit([7, 8, 9, 10], max_new_tokens=8) for _ in range(2)]
    for r in r2:
        assert len(r.result(timeout=60)["tokens"]) == 8
    assert fn.trace_counter["traces"] == t0
    assert engine.cache.stats()["misses"] == m0


def test_prefill_traces_bounded_by_buckets(engine):
    pf8 = engine.decoder.prefill_fn(1, 8)
    t0 = pf8.trace_counter["traces"]
    m0 = engine.cache.stats()["misses"]
    assert t0 == 1
    for prompt in ([1], [1, 2, 3], [1, 2, 3, 4, 5, 6]):   # all bucket 8
        engine.submit(prompt, max_new_tokens=2).result(timeout=60)
    assert pf8.trace_counter["traces"] == t0
    # one entry per bucket and the decode step, all made at warm-up
    assert engine.cache.stats()["misses"] == m0 == 3
    assert engine.stats()["executable_cache"]["misses"] == 3


def test_midstream_join_and_leave(engine):
    """A long request streams while a short one joins mid-flight and
    leaves first, and a third reuses its slot: no new trace."""
    fn = _decode_fn(engine)
    t0 = fn.trace_counter["traces"]
    long_req = engine.submit([1, 2, 3], max_new_tokens=40, stream=True)
    it = long_req.iter_tokens(timeout=60)
    first = [next(it) for _ in range(4)]
    short = engine.submit([4, 5], max_new_tokens=3).result(timeout=60)
    assert len(short["tokens"]) == 3
    assert short["finish_reason"] == "length"
    third = engine.submit([6], max_new_tokens=3)
    assert len(third.result(timeout=60)["tokens"]) == 3
    rest = list(it)
    assert len(first) + len(rest) == 40
    assert long_req.result(timeout=60)["tokens"] == first + rest
    assert fn.trace_counter["traces"] == t0


# -- tokens --------------------------------------------------------------------

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 14)), [7])


@pytest.fixture(scope="module")
def jax_tokens(models):
    eng = JLLMEngine(models[0], JConfig(**ENGINE), registry=JStatRegistry())
    try:
        reqs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        return [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        eng.drain(timeout=60)


def _serve(model, layout, **kw):
    eng = LLMEngine(model, LLMEngineConfig(**ENGINE, **LAYOUTS[layout]),
                    **kw)
    try:
        reqs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        return [r.result(timeout=120)["tokens"] for r in reqs], eng
    finally:
        eng.drain(timeout=60)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_compiled_engine_greedy_tokens_equal_jax(models, jax_tokens,
                                                 layout):
    tokens, eng = _serve(models[1], layout)
    assert eng.cache is default_cache()
    assert tokens == jax_tokens
    stats = eng.stats()
    assert stats["graph_pool_bytes"] == 0          # no pool on the CPU
    assert stats["executable_cache"] == default_cache().stats()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eager_lane_gives_the_same_tokens_and_traces_nothing(
        models, jax_tokens, layout):
    cache = ExecutableCache()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        tokens, eng = _serve(models[1], layout, cache=cache)
    assert graphs.graphs_enabled()
    assert tokens == jax_tokens
    fn = _decode_fn(eng)
    assert fn.trace_counter["traces"] == 0


def test_two_same_shape_engines_give_their_own_tokens(models):
    """Two models of one config serve through one program per signature
    (the shared default cache), each bound to its own KV cache."""
    other = GPTForCausalLM(GPTConfig(**MODEL), device="cpu", seed=5).eval()
    cfg = LLMEngineConfig(**ENGINE)
    engines = [LLMEngine(m, cfg) for m in (models[1], other)]
    try:
        fn = _decode_fn(engines[0])
        assert fn is _decode_fn(engines[1])
        reqs = [[e.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
                for e in engines]
        got = [[r.result(timeout=60)["tokens"] for r in rs] for rs in reqs]
    finally:
        for e in engines:
            e.drain(timeout=60)
    for m, toks in zip((models[1], other), got):
        for p, t in zip(PROMPTS[:2], toks):
            ref = m.generate(np.array([p]), max_length=6).numpy()[0]
            assert t == ref[len(p):].tolist()
    assert got[0] != got[1]


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_generate_twice_traces_once(models, strategy):
    """A second ``generate`` at the same rows and max_seq reuses the
    first's programs and cache: no new trace, no cache miss; and its
    tokens equal the eager lane's (sampling from one seed)."""
    pm = models[1]
    ids = np.random.default_rng(3).integers(0, MODEL["vocab_size"], (2, 7))
    kw = dict(max_length=9, decode_strategy=strategy, top_k=5)
    dec = GPTStaticDecoder(pm, max_top_k=5 if strategy == "sampling" else 0)
    seed(11)
    first = pm.generate(ids, **kw).numpy()
    decode = dec.decode_fn(2, 16)
    prefill = dec.prefill_fn(2, 8)
    traces = (decode.trace_counter["traces"],
              prefill.trace_counter["traces"])
    misses = default_cache().stats()["misses"]
    seed(11)
    second = pm.generate(ids, **kw).numpy()
    assert (decode.trace_counter["traces"],
            prefill.trace_counter["traces"]) == traces
    assert default_cache().stats()["misses"] == misses
    np.testing.assert_array_equal(first, second)
    seed(11)
    with graphs.disable_graphs():
        eager = pm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(first, eager)
    assert (decode.trace_counter["traces"],
            prefill.trace_counter["traces"]) == traces


# -- the program's binding rules ------------------------------------------------

def _decoder_case(pm, cache):
    dec = GPTStaticDecoder(pm, max_top_k=0, exec_cache=cache)
    kv = dec.new_kv(2, 16)
    params = dec.params()
    samp = pack_sampling([SamplingParams()] * 2, "cpu")
    fin = torch.zeros(2, dtype=torch.bool)
    last = torch.tensor([3, 4], dtype=torch.int32)
    return dec, kv, params, samp, fin, last


def test_program_traces_once_per_cache_and_drops_a_collected_one(models):
    cache = ExecutableCache()
    dec, kv, params, samp, fin, last = _decoder_case(models[1], cache)
    fn = dec.decode_fn(2, 16)
    dec.decode_step(kv, params, fin, last, samp, None)
    dec.decode_step(kv, params, fin, last, samp, None)
    assert fn.trace_counter["traces"] == 1
    kv2 = dec.new_kv(2, 16)
    dec.decode_step(kv2, params, fin, last, samp, None)
    assert fn.trace_counter["traces"] == 2
    # another generator is another binding, as None vs a key retraces jit
    dec.decode_step(kv2, params, fin, last, samp, torch.Generator())
    assert fn.trace_counter["traces"] == 3
    assert len(fn._bound) == 2
    del kv2
    gc.collect()
    assert len(fn._bound) == 1
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 4


def test_program_copies_inputs_into_its_first_call_tensors(models):
    """The first call's tensors are the program's inputs and its outputs
    the same buffers every call: a later call with other tensors copies
    their values in, and gives the eager lane's tokens."""
    dec, kv, params, samp, fin, last = _decoder_case(models[1],
                                                     ExecutableCache())
    eager_kv = dec.new_kv(2, 16)
    last0 = last.clone()
    outs = []
    step_last = last
    for _ in range(4):
        nxt, f = dec.decode_step(kv, params, fin, step_last, samp, None)
        outs.append(nxt.clone())
        step_last = nxt
    assert nxt is dec.decode_step(kv, params, fin, step_last, samp,
                                  None)[0]
    ref, step_last = [], last0
    with graphs.disable_graphs():
        for _ in range(4):
            nxt, _ = dec.decode_step(eager_kv, params, fin, step_last, samp,
                                     None)
            ref.append(nxt.clone())
            step_last = nxt
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    # the first call's last-token tensor now holds the last input copied in
    assert torch.equal(last, outs[-1])


def test_program_refuses_moved_weights_and_mismatched_inputs(models):
    dec, kv, params, samp, fin, last = _decoder_case(models[1],
                                                     ExecutableCache())
    dec.decode_step(kv, params, fin, last, samp, None)
    dec.decode_step(kv, dec.params(), fin, last, samp, None)  # same tensors
    moved = dict(params, tok=params["tok"].clone())
    with pytest.raises(RuntimeError, match="copy new weights in place"):
        dec.decode_step(kv, moved, fin, last, samp, None)
    with pytest.raises(ValueError, match="does not match"):
        dec.decode_step(kv, params, fin, last[:1], samp, None)


def test_eviction_and_clear_release_the_programs(models):
    cache = ExecutableCache(capacity=1)
    dec, kv, params, samp, fin, last = _decoder_case(models[1], cache)
    fn = dec.decode_fn(2, 16)
    dec.decode_step(kv, params, fin, last, samp, None)
    assert len(fn._bound) == 1 and len(cache) == 1
    dec.decode_fn(2, 32)          # evicts (2, 16): its graphs go
    assert cache.stats()["evictions"] == 1 and len(fn._bound) == 0
    assert not cache.contains(dec._key + ("decode", 2, 16))
    fn32 = dec.decode_fn(2, 32)
    kv32 = dec.new_kv(2, 32)
    dec.decode_step(kv32, params, fin, last, samp, None)
    assert len(fn32._bound) == 1
    cache.clear()
    assert len(cache) == 0 and len(fn32._bound) == 0
    assert dec.decode_fn(2, 32) is not fn32


def test_get_decode_step_makes_a_program_per_entry(models):
    spec = GPTStaticDecoder(models[1]).spec
    a, b = get_decode_step(spec, 0), get_decode_step(spec, 0)
    assert a is not b and a.trace_counter == {"traces": 0}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cache_reset_keeps_addresses_and_zeroes_in_place(models, layout):
    pm = models[1]
    dec = (GPTStaticDecoder(pm) if layout == "slot"
           else GPTPagedDecoder(pm, page_size=4))
    kv = dec.new_kv(2, 16)
    kv.alloc()
    if layout == "paged":
        kv.ensure_pages(0, 9)
        bt = kv.block_tables
        assert bt[0, :3].tolist() == [0, 1, 2]
    kv.k.fill_(1.0)
    kv.lengths.fill_(5)
    ptrs = [t.data_ptr() for t in (kv.k, kv.v, kv.lengths)]
    kv.reset()
    assert [t.data_ptr() for t in (kv.k, kv.v, kv.lengths)] == ptrs
    assert not kv.k.any() and not kv.lengths.any()
    if layout == "paged":
        assert kv.block_tables is bt
        assert (bt == kv.trash).all()


def test_engine_warmup_and_ticks_keep_static_buffers(models):
    """The engine's per-step vectors are written in place, never rebound,
    so the decode program binds them once and copies nothing per tick."""
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE),
                    cache=ExecutableCache())
    b = eng._batcher
    bufs = (b._last, b._finished, *b._samp_vecs)
    try:
        eng.submit([1, 2, 3], max_new_tokens=5, top_k=3, do_sample=True,
                   temperature=0.7).result(timeout=60)
        eng.submit([4, 5], max_new_tokens=5).result(timeout=60)
    finally:
        eng.drain(timeout=60)
    assert all(x is y for x, y in zip((b._last, b._finished,
                                       *b._samp_vecs), bufs))
    bound = next(iter(_decode_fn(eng)._bound.values()))[b._gen]
    assert bound.inputs[0] is b._finished and bound.inputs[1] is b._last
    assert bound.inputs[2] is b._samp_vecs


def test_collector_held_nests_and_restores_the_collector():
    """Captures hold Python's cyclic collector off (a graph collected
    inside another capture would invalidate it): nested holds keep it off
    until the outermost ends, which restores what it found."""
    import gc
    from paddle_tpu_torch.core import graphs
    assert gc.isenabled()
    with graphs._collector_held():
        assert not gc.isenabled()
        with graphs._collector_held():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._collector_held():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()
