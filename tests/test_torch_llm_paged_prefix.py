"""The port's paged prefix sharing and paged speculative decoding against
the JAX package's (its ``tests/test_llm_paged.py``: TestPrefixSharing,
the composed spec parity, the mid-stream eviction and
``TestPagedKVCache.test_adopt_shared_and_copied``): an aligned hit
copies 0 bytes, a partial-page divergence makes one COW split, shared
pages stay immutable (every request decodes as in an unshared engine),
``evict_unpinned`` releases pages, paged-spec tokens equal slot-spec
tokens equal plain slot tokens equal the JAX package's, the counters
equal the JAX engine's and the pool is leak-free after a drain. Tiny
model: vocab 64, hidden 32, 2 layers, 4 heads, 8-token pages."""
import dataclasses

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
from paddle_tpu.serving.llm.paged import PagedKVCache as JPagedKVCache  # noqa: E402
from paddle_tpu.serving.llm.paged.prefix import \
    PagedPrefixStore as JPagedPrefixStore  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig, PrefixStore)
from paddle_tpu_torch.serving.llm.paged import (PagedKVCache,  # noqa: E402
                                                PagedPrefixStore,
                                                PagesExhausted)

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
BASE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16, 40), seed=3)
PAGED = dict(BASE, kv_layout="paged", page_size=8)
NEW = 4


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
    cfg = dataclasses.asdict(GPTConfig(**MODEL).draft(2, num_layers=1))
    return _pair(cfg, 1)


def _run(eng, prompts, new=NEW):
    """The prompts one at a time (a deterministic store state at each
    admission); the engine stays up for its counters."""
    return [eng.generate(list(p), max_new_tokens=new)["tokens"]
            for p in prompts]


def _drained_pool(eng):
    """Drain, drop the store's entries, and return the pool."""
    kv = eng._batcher.kv
    eng.drain(timeout=60)
    if eng.prefix_store is not None:
        eng.prefix_store.clear()
    return kv.pool


def _aligned_prompts():
    rng = np.random.default_rng(11)
    sysp = list(rng.integers(0, 64, 24))        # 3 pages of 8
    return [sysp + [1, 2, 3], sysp + [1, 2, 3], sysp + [9, 9]]


def _cow_prompts():
    rng = np.random.default_rng(13)
    p1 = list(rng.integers(0, 64, 32))          # 4 pages, aligned
    p2 = p1[:30] + [(p1[30] + 1) % 64]          # diverges inside page 4
    return [p1, p2, p1]


def _both(models, prompts, **kw):
    """The same config and prompts through both packages' engines:
    ``(port tokens, port engine, JAX tokens, JAX engine)``."""
    jm, pm = models
    teng = LLMEngine(pm, LLMEngineConfig(**PAGED, **kw),
                     registry=StatRegistry())
    jeng = JLLMEngine(jm, JConfig(**PAGED, **kw), registry=JStatRegistry())
    return _run(teng, prompts), teng, _run(jeng, prompts), jeng


@pytest.fixture(scope="module")
def unshared(models):
    """Each prompt of both sets through a paged engine without reuse."""
    eng = LLMEngine(models[1], LLMEngineConfig(**PAGED))
    out = {tuple(p): t for p, t in zip(
        _aligned_prompts() + _cow_prompts(),
        _run(eng, _aligned_prompts() + _cow_prompts()))}
    assert _drained_pool(eng).pages_in_use == 0
    return out


_COUNTERS = ("serving.llm.prefix.hits", "serving.llm.prefix.misses",
             "serving.llm.prefix.hit_tokens", "serving.llm.prefix.inserts",
             "serving.llm.prefix.bytes_shared",
             "serving.llm.prefix.bytes_copied",
             "serving.llm.prefix.reused_tokens",
             "serving.llm.prefix.cow_splits", "serving.llm.pages_cow_splits",
             "serving.llm.pages_free")


def test_aligned_hit_is_zero_copy(models, unshared):
    prompts = _aligned_prompts()
    got, teng, ref, jeng = _both(models, prompts, prefix_cache=True)
    assert got == ref
    assert got == [unshared[tuple(p)] for p in prompts]
    ps = teng.prefix_store.stats()
    assert ps == jeng.prefix_store.stats()
    assert ps["hits"] == 2 and ps["misses"] == 1
    # 27-token prompts align to a 3-page head: each hit splices 3 pages
    assert ps["bytes_copied"] == 0
    assert ps["bytes_shared"] == 2 * 3 * teng._batcher.kv.page_nbytes()
    assert teng._batcher.kv.page_nbytes() == \
        jeng._batcher.kv.page_nbytes()
    assert [teng.registry.get(n) for n in _COUNTERS] == \
        [jeng.registry.get(n) for n in _COUNTERS]
    assert teng.stats()["pages"]["cow_splits"] == 0
    assert _drained_pool(teng).pages_in_use == 0
    jeng.drain(timeout=60)


@pytest.mark.parametrize("n_req,splits", [(2, 1), (3, 2)])
def test_cow_split_on_partial_page_divergence(models, unshared, n_req,
                                              splits):
    """p2 shares 3 full pages of p1 and COW-splits the 4th (rows 24..29
    reused from the copy, row 30 written into it): one split, one page
    copied; p1 sent again splits the 4th page too (its reuse cap of 31
    tokens ends inside it). Every request decodes as an unshared engine
    does."""
    prompts = _cow_prompts()[:n_req]
    got, teng, ref, jeng = _both(models, prompts, prefix_cache=True)
    kv = teng._batcher.kv
    assert got == ref
    assert got == [unshared[tuple(p)] for p in prompts]
    assert got[-1] == got[0] or n_req == 2
    ps = teng.prefix_store.stats()
    assert ps == jeng.prefix_store.stats()
    assert kv.cow_splits == jeng._batcher.kv.cow_splits == splits
    assert ps["bytes_copied"] == splits * kv.page_nbytes()
    assert teng.registry.get("serving.llm.pages_cow_splits") == splits
    assert [teng.registry.get(n) for n in _COUNTERS] == \
        [jeng.registry.get(n) for n in _COUNTERS]
    pool = _drained_pool(teng)
    assert pool.pages_in_use == 0
    assert pool.total_allocs + pool.total_retains == pool.total_releases
    jeng.drain(timeout=60)


def test_no_tick_writes_a_shared_page(models):
    """Shared pages are immutable: while sequences that share a cached
    head decode, the rows of the store's pages never change."""
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**PAGED, prefix_cache=True))
    p1, p2, _ = _cow_prompts()
    eng.generate(p1, max_new_tokens=2)
    kv = eng._batcher.kv
    (entry,) = eng.prefix_store._entries.values()
    before = kv.k[list(entry.page_ids)].clone()
    reqs = [eng.submit(p, max_new_tokens=12) for p in (p1, p2, p1 + [5])]
    for r in reqs:
        r.result(120)
    assert torch.equal(kv.k[list(entry.page_ids)], before)
    assert _drained_pool(eng).pages_in_use == 0


def test_store_evict_unpinned_releases_pages_like_jax():
    counts = []
    for cache, store_cls, reg in (
            (PagedKVCache, PagedPrefixStore, StatRegistry),
            (JPagedKVCache, JPagedPrefixStore, JStatRegistry)):
        kw = dict(num_slots=2, num_layers=1, max_seq=16, num_heads=2,
                  head_dim=4, page_size=4, num_pages=8)
        if cache is PagedKVCache:
            kw["device"] = "cpu"
        kv = cache(**kw)
        store = store_cls(kv, capacity_pages=8, registry=reg())
        slot = kv.alloc()
        kv.ensure_pages(slot, 8)
        entry = store.insert(np.arange(8, dtype=np.int32),
                             kv.slot_page_ids(slot), (1, 2, 4, "float32", 4))
        kv.free(slot)                         # the store keeps the pages
        seen = [kv.pool.pages_in_use, store.evict_unpinned(2)]
        store.unpin(entry)
        seen += [store.evict_unpinned(2), kv.pool.pages_in_use,
                 store.stats()]
        counts.append(seen)
    assert counts[0] == counts[1]
    assert counts[0][:4] == [2, 0, 2, 0]


def test_adopt_shared_and_copied_like_jax():
    out = []
    for cache in (PagedKVCache, JPagedKVCache):
        kw = dict(num_slots=3, num_layers=1, max_seq=16, num_heads=2,
                  head_dim=4, page_size=4, num_pages=12)
        if cache is PagedKVCache:
            kw["device"] = "cpu"
        kv = cache(**kw)
        owner = kv.alloc()
        kv.ensure_pages(owner, 4)
        pid = kv.slot_page_ids(owner)[0]
        kv.pool.retain(pid)                   # the store's reference
        other = kv.alloc()
        kv.adopt_shared_page(other, pid)
        seen = [kv.pool.refcount(pid), kv.slot_page_ids(other),
                kv.mapped_pages(other), kv.mapped_tokens(other)]
        if cache is PagedKVCache:
            kv.k[pid].copy_(torch.arange(kv.k[pid].numel(),
                                         dtype=torch.float32).view_as(
                                             kv.k[pid]))
        third = kv.alloc()
        new_pid = kv.adopt_copied_page(third, pid)
        seen += [new_pid, kv.cow_splits, kv.pool.refcount(pid),
                 kv.pool.refcount(new_pid), kv.page_nbytes()]
        assert np.array_equal(np.asarray(kv.k[new_pid]),
                              np.asarray(kv.k[pid]))
        kv.set_length(third, 7)
        seen.append(int(np.asarray(kv.host_lengths())[third]))
        for s in (owner, other, third):
            kv.free(s)
        kv.pool.release(pid)
        seen.append(kv.pool.pages_in_use)
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][0] == 3 and out[0][6] == 3 and out[0][-1] == 0
    with pytest.raises(ValueError, match="set_length"):
        kv.set_length(0, 17)


def _prompts_spec():
    rng = np.random.default_rng(5)
    return [list(rng.integers(0, 64, n)) for n in (5, 11, 20)]


@pytest.mark.parametrize("draft", ["self", "other"])
def test_spec_decode_composed_parity(models, drafts, draft):
    """paged spec == slot spec == plain slot == the JAX paged spec
    engine's tokens, the same ``spec.*`` counters, and a leak-free pool;
    with prefix sharing on as well, the same tokens again."""
    jm, pm = models
    jdm, pdm = models if draft == "self" else drafts
    prompts = _prompts_spec() * 2
    plain = _run(LLMEngine(pm, LLMEngineConfig(**BASE)), prompts, new=6)
    slot = LLMEngine(pm, LLMEngineConfig(**BASE, spec_k=2),
                     draft_model=pdm)
    slot_out = _run(slot, prompts, new=6)
    paged = LLMEngine(pm, LLMEngineConfig(**PAGED, spec_k=2),
                      registry=StatRegistry(), draft_model=pdm)
    paged_out = _run(paged, prompts, new=6)
    jeng = JLLMEngine(jm, JConfig(**PAGED, spec_k=2),
                      registry=JStatRegistry(), draft_model=jdm)
    ref = _run(jeng, prompts, new=6)
    assert paged_out == slot_out == plain == ref
    names = ("serving.llm.spec.proposed", "serving.llm.spec.accepted",
             "serving.llm.spec.ticks", "serving.llm.spec.fallback_ticks")
    assert [paged.registry.get(n) for n in names] == \
        [jeng.registry.get(n) for n in names]
    assert paged.registry.get("serving.llm.spec.ticks") > 0
    assert _drained_pool(paged).pages_in_use == 0
    jeng.drain(timeout=60)
    slot.drain(timeout=60)
    both = LLMEngine(pm, LLMEngineConfig(**PAGED, spec_k=3,
                                         prefix_cache=True),
                     draft_model=pdm)
    assert _run(both, prompts, new=6) == plain
    assert both.prefix_store.stats()["hits"] >= 2
    assert _drained_pool(both).pages_in_use == 0


def test_midstream_eviction_reclaims_pages(models):
    """Two sequences whose growth outruns an 8-page pool under
    speculation (pages mapped for k+1 rows ahead): the younger is evicted
    mid-stream, its pages return, the survivor finishes."""
    _, pm = models
    eng = LLMEngine(pm, LLMEngineConfig(**dict(PAGED, num_pages=8,
                                               num_slots=2, spec_k=2)),
                    draft_model=pm)
    rng = np.random.default_rng(19)
    reqs = [eng.submit(list(rng.integers(0, 64, 20)), max_new_tokens=30)
            for _ in range(2)]
    results, errors = [], []
    for r in reqs:
        try:
            results.append(r.result(120)["tokens"])
        except PagesExhausted as e:
            errors.append(e)
    assert len(errors) == 1 and "page" in str(errors[0]).lower()
    assert len(results) == 1 and len(results[0]) == 30
    assert eng.registry.get("serving.llm.pages_evicted_midstream") >= 1
    assert _drained_pool(eng).pages_in_use == 0


def test_paged_engine_refuses_an_explicit_store(models):
    _, pm = models
    with pytest.raises(NotImplementedError, match="prefix_cache=True"):
        LLMEngine(pm, LLMEngineConfig(**PAGED, warmup=False),
                  prefix_store=PrefixStore())
    eng = LLMEngine(pm, LLMEngineConfig(**PAGED, warmup=False,
                                        prefix_cache=True))
    with pytest.raises(NotImplementedError, match="block table"):
        eng.decoder.insert_prefix(eng._batcher.kv, None, None, 0)
    assert eng.decoder.prefix_sig(eng._batcher.kv) == \
        (2, 4, 8, "float32", 8)
    eng.drain(timeout=60)
