"""The port's int8 serving on the paged layout against the JAX package's:
the int8 arena writers and the gather byte for byte, the int8
``PagedKVCache`` (its leaves, reset, the COW copy of both leaves, its
bytes), the JAX package's ``test_int8_page_parity`` (paged int8 tokens
equal slot int8 tokens) on both packages, the lane rules (``"auto"`` is
the gather lane over int8 pages on CUDA too, ``"kernel"`` over int8 pages
raises, B4's wrapper refuses an int8 arena, the tail prefill over int8
pages raises), and the paged engines' greedy tokens against the JAX
engines' for int8 weights (on the gather and the kernel lane, and under
prefix reuse), int8 KV and both. Tiny model: vocab 64, hidden 32, 2
layers, 4 heads, 8-token pages, spread weights."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.ops import paged_attention as jpa  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu.serving.llm.paged import GPTPagedDecoder as JPaged  # noqa: E402
from paddle_tpu.serving.llm.paged import pool as jpool  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core import graphs  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.serving import ExecutableCache  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig)
from paddle_tpu_torch.serving.llm import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder  # noqa: E402
from paddle_tpu_torch.serving.llm.paged import pool as tpool  # noqa: E402
from paddle_tpu_torch.serving.llm.paged.decode import (  # noqa: E402
    _resolve_attn_impl)

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16, 32), seed=3)
PAGED = dict(kv_layout="paged", page_size=8)
COMBOS = {"w8": ("int8", "float32"), "kv8": ("float32", "int8"),
          "w8kv8": ("int8", "int8")}


@pytest.fixture(scope="module")
def models():
    """The JAX model with weights of a wider spread than its init (so
    greedy tokens vary), and the port's model carrying them."""
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in jm.state_dict().items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        sd[k] = (a * 0.3 if v.ndim > 1 else a * 0.1 + (
            1.0 if "norm" in k and k.endswith("weight") else 0.0)
        ).astype(np.float32)
    jm.set_state_dict(sd)
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    return jm, pm


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, MODEL["vocab_size"], n).astype(np.int32)
            for n in (5, 11, 20)]


def _serve(engine, prompts=None, new=6):
    """Each prompt in turn, then drain; returns the token lists and the
    engine's cache (for its leak and dtype checks)."""
    kv = engine._batcher.kv
    try:
        toks = [engine.submit(p, max_new_tokens=new).result(120)["tokens"]
                for p in (prompts if prompts is not None else _prompts())]
    finally:
        engine.drain(timeout=60)
    return toks, kv


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _arenas(seed, *shape):
    """The same int8 arena in both packages (each quantizing the same
    float rows; the codes are byte-equal)."""
    x = _rand(seed, *shape)
    return (jpool.quantize_kv_rows(jnp.asarray(x)),
            tkv.quantize_kv_rows(torch.from_numpy(x)))


def _same(got, ref):
    for leaf in ("q", "s"):
        assert got[leaf].numpy().tobytes() == np.asarray(ref[leaf]).tobytes()


# -- the arena ----------------------------------------------------------------

def test_int8_arena_writers_and_gather_byte_equal_jax():
    """``paged_write_rows`` (one layer's view, rows to the trash page
    colliding), ``paged_write_prompt_rows`` (all layers) and
    ``paged_gather_rows`` over int8 arenas: codes and scales byte-equal
    to the JAX package's, written in place."""
    ja, ta = _arenas(1, 7, 2, 4, 2, 4)           # 6 pages + trash, page 4
    rows = _rand(2, 3, 2, 4)
    pids = np.asarray([2, 6, 6], np.int32)
    ppos = np.asarray([1, 3, 0], np.int32)
    jv = {"q": ja["q"][:, 1], "s": ja["s"][:, 1]}
    tv = tkv.kv_layer_view(ta, 1)
    jout = jpool.paged_write_rows(jv, jnp.asarray(rows), jnp.asarray(pids),
                                  jnp.asarray(ppos))
    assert tpool.paged_write_rows(tv, torch.from_numpy(rows),
                                  torch.from_numpy(pids),
                                  torch.from_numpy(ppos)) is tv
    _same({"q": ta["q"][:, 1], "s": ta["s"][:, 1]}, jout)
    ja, ta = _arenas(4, 7, 2, 4, 2, 4)
    prompt = _rand(3, 5, 2, 2, 4)
    pp = np.asarray([0, 0, 3, 3, 6], np.int32)
    po = np.asarray([0, 1, 2, 3, 1], np.int32)
    jall = jpool.paged_write_prompt_rows(ja, jnp.asarray(prompt),
                                         jnp.asarray(pp), jnp.asarray(po))
    tpool.paged_write_prompt_rows(ta, torch.from_numpy(prompt),
                                  torch.from_numpy(pp), torch.from_numpy(po))
    _same(ta, jall)
    bt = np.asarray([[3, 0, 6], [1, 1, 5]], np.int32)
    jg = jpool.paged_gather_rows({"q": jall["q"][:, 0],
                                  "s": jall["s"][:, 0]}, jnp.asarray(bt))
    tg = tpool.paged_gather_rows(tkv.kv_layer_view(ta, 0),
                                 torch.from_numpy(bt))
    assert tuple(tg["q"].shape) == (2, 12, 2, 4)
    assert tuple(tg["s"].shape) == (2, 12)
    _same(tg, jg)


def test_int8_paged_cache_leaves_reset_cow_and_bytes():
    """The int8 ``PagedKVCache``: codes and per-row scales of the JAX
    package's shapes and bytes (so a page's bytes, the prefix store's
    unit, count codes and scales), a COW copy of both leaves, a reset in
    place."""
    kw = dict(num_slots=2, num_layers=3, max_seq=32, num_heads=2,
              head_dim=8, kv_dtype="int8", page_size=8, num_pages=6)
    kv = tpool.PagedKVCache(**kw, device="cpu")
    jc = jpool.PagedKVCache(**kw)
    assert kv.quantized and tuple(kv.k["q"].shape) == jc.k["q"].shape
    assert tuple(kv.k["s"].shape) == jc.k["s"].shape == (7, 3, 8)
    assert kv.kv_bytes() == jc.kv_bytes()
    assert kv.page_nbytes() == jc.page_nbytes()
    dense = tpool.PagedKVCache(**dict(kw, kv_dtype=None), device="cpu")
    assert dense.kv_bytes() / kv.kv_bytes() >= 1.8
    slot = kv.alloc()
    kv.ensure_pages(slot, 8)
    src = kv.slot_page_ids(slot)[0]
    kv.k["q"][src] = 5
    kv.v["s"][src] = 0.25
    dst = kv.adopt_copied_page(kv.alloc(), src)
    assert dst != src and int(kv.k["q"][dst].min()) == 5
    assert float(kv.v["s"][dst].min()) == 0.25
    ptrs = [t.data_ptr() for t in tkv.kv_leaves(kv.k) + tkv.kv_leaves(kv.v)]
    kv.reset()
    assert [t.data_ptr() for t in tkv.kv_leaves(kv.k)
            + tkv.kv_leaves(kv.v)] == ptrs
    assert int(kv.k["q"].abs().sum()) == 0
    with pytest.raises(ValueError):
        tpool.PagedKVCache(**dict(kw, kv_dtype="fp8"), device="cpu")


# -- the lanes ----------------------------------------------------------------

@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_auto_lane_over_int8_pages_is_gather_and_kernel_raises(
        models, device_type):
    """Over int8 pages "auto" is the gather lane on CUDA too (the kernel
    reads dense arenas, as the JAX package's), "kernel" raises in both
    packages; over dense pages with int8 weights "auto" stays the kernel
    on CUDA."""
    jm, pm = models
    for dt in ("float32", "int8"):
        got = _resolve_attn_impl("auto", device_type, 8, torch.float32, dt)
        want = ("kernel" if device_type == "cuda" and dt == "float32"
                else "gather")
        assert got == want
    with pytest.raises(ValueError, match="dense arenas"):
        _resolve_attn_impl("kernel", device_type, 8, torch.float32, "int8")
    with pytest.raises(ValueError, match="int8 pages"):
        GPTPagedDecoder(pm, kv_dtype="int8", attn_impl="kernel")
    with pytest.raises(ValueError, match="int8 pages"):
        JPaged(jm, kv_dtype="int8", attn_impl="kernel")
    dec = GPTPagedDecoder(pm, weight_dtype="int8", kv_dtype="int8")
    assert dec.attn_impl == "gather"
    assert GPTPagedDecoder(pm, weight_dtype="int8",
                           attn_impl="kernel").attn_impl == "kernel"


def test_paged_attention_refuses_an_int8_arena_as_jax():
    """B4's wrapper refuses int8 pages (the ``{"q", "s"}`` dict, or an
    int8 tensor) on every device, as the JAX package's refuses them."""
    q = np.zeros((1, 2, 4), np.float32)
    bt = np.zeros((1, 2), np.int32)
    pos = np.zeros((1,), np.int32)
    jarena = {"q": jnp.zeros((3, 4, 2, 4), jnp.int8),
              "s": jnp.zeros((3, 4), jnp.float32)}
    with pytest.raises(ValueError, match="dense"):
        jpa.paged_attention(jnp.asarray(q), jarena, jarena,
                            jnp.asarray(bt), jnp.asarray(pos))
    tarena = {"q": torch.zeros((3, 4, 2, 4), dtype=torch.int8),
              "s": torch.zeros((3, 4))}
    before = tpa.paged_attention.launches
    for arena in (tarena, tarena["q"]):
        with pytest.raises(ValueError, match="dense"):
            tpa.paged_attention(torch.from_numpy(q), arena, arena,
                                torch.from_numpy(bt), torch.from_numpy(pos))
    assert tpa.paged_attention.launches == before


def test_paged_tail_prefill_over_int8_pages_raises_as_jax(models):
    jm, pm = models
    td = GPTPagedDecoder(pm, page_size=8, kv_dtype="int8")
    jd = JPaged(jm, page_size=8, kv_dtype="int8")
    for dec, kv in ((td, td.new_kv(2, 32)), (jd, jd.new_kv(2, 32))):
        with pytest.raises(NotImplementedError, match="int8"):
            dec.tail_prefill(kv, dec.params(), *([None] * 7))


# -- the engines --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens(models):
    jm, _ = models
    out = {}
    for combo, (w, kvd) in COMBOS.items():
        out[combo] = _serve(JLLMEngine(jm, JConfig(
            **ENGINE, **PAGED, weight_dtype=w, kv_dtype=kvd)))[0]
    out["slot_kv8"] = _serve(JLLMEngine(jm, JConfig(**ENGINE,
                                                    kv_dtype="int8")))[0]
    return out


def test_int8_page_parity_on_both_packages(models, jax_tokens):
    """The JAX package's ``test_int8_page_parity``: paged int8-KV tokens
    equal slot int8-KV tokens, in the JAX package and in the port, and
    the two packages agree; every page goes back to the pool."""
    _, pm = models
    assert jax_tokens["kv8"] == jax_tokens["slot_kv8"]
    slot, _ = _serve(LLMEngine(pm, LLMEngineConfig(**ENGINE,
                                                   kv_dtype="int8")))
    paged, kv = _serve(LLMEngine(pm, LLMEngineConfig(**ENGINE, **PAGED,
                                                     kv_dtype="int8")))
    assert kv.quantized
    assert paged == slot == jax_tokens["kv8"]
    assert kv.pool.pages_in_use == 0
    assert kv.pool.total_allocs == kv.pool.total_releases


@pytest.mark.parametrize("lane", ["graphed", "eager"])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_paged_engine_gives_the_jax_engines_tokens(models, jax_tokens, combo,
                                                   lane):
    """The paged engine with int8 weights, int8 KV or both, graphed and
    on the eager lane: the JAX paged engine's greedy tokens."""
    w, kvd = COMBOS[combo]
    cfg = LLMEngineConfig(**ENGINE, **PAGED, weight_dtype=w, kv_dtype=kvd)
    if lane == "eager":
        with graphs.disable_graphs():
            toks, kv = _serve(LLMEngine(models[1], cfg,
                                        cache=ExecutableCache()))
    else:
        eng = LLMEngine(models[1], cfg, cache=ExecutableCache())
        toks, kv = _serve(eng)
        assert eng.decoder.decode_fn(4, 64).trace_counter["traces"] == 1
    assert toks == jax_tokens[combo]
    assert len({t for r in toks for t in r}) > 3
    assert kv.quantized == (kvd == "int8")


def test_int8_weight_kernel_lane_gives_the_jax_tokens(models, jax_tokens):
    """int8 weights over dense pages on the kernel lane (B4's path on the
    card; its plain version here): the JAX gather engine's tokens, and no
    launch counted on the CPU."""
    before = tpa.paged_attention.launches
    eng = LLMEngine(models[1], LLMEngineConfig(
        **ENGINE, **PAGED, weight_dtype="int8", paged_attn_impl="kernel"))
    assert eng.decoder.attn_impl == "kernel"
    toks, _ = _serve(eng)
    assert toks == jax_tokens["w8"]
    assert tpa.paged_attention.launches == before


def test_int8_weights_with_paged_prefix_reuse_give_the_jax_tokens(models):
    """int8 weights under paged prefix reuse (shared pages, the paged
    tail prefill through ``_mm``): the JAX engine's tokens and hits."""
    jm, pm = models
    prompts = _prompts()
    prompts[2][:16] = np.concatenate([prompts[1], prompts[0][:5]])
    kw = dict(ENGINE, **PAGED, weight_dtype="int8", prefix_cache=True)
    ref, _ = _serve(JLLMEngine(jm, JConfig(**kw)), prompts * 2)
    eng = LLMEngine(pm, LLMEngineConfig(**kw), cache=ExecutableCache())
    got, kv = _serve(eng, prompts * 2)
    assert got == ref
    assert eng.stats()["stats"]["serving.llm.prefix.hits"] >= 3
