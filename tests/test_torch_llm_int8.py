"""The port's int8 serving on the static-slot layout against the JAX
package's: ``quantize_kv_rows``, ``quantize_gpt_params`` and both int8
KV writers byte for byte; the int8 cache's helpers and its memory bar
(int8 KV holds >= 1.8x the sequences of fp32 KV in the same bytes); one
prefill and one decode step at 1e-5 for int8 weights with fp32 KV, fp32
weights with int8 KV and both int8; the engines' greedy tokens equal the
JAX engines' for those three in the graphed and the eager lane, and for
int8 weights under prefix reuse; the reference's gates (prefix, spec and
a shared store over int8 KV), the port's refusal of speculation over
int8 weights where the JAX engine fails with a ``TypeError``, and the
in-place re-quantization that keeps a captured program's weights.
Tiny model: vocab 64, hidden 32, 2 layers, 4 heads, weights spread so
that greedy tokens vary."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu.serving.llm import decode as jdec  # noqa: E402
from paddle_tpu.serving.llm import kvcache as jkv  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core import graphs  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import ExecutableCache  # noqa: E402
from paddle_tpu_torch.serving.llm import (GPTStaticDecoder,  # noqa: E402
                                          LLMEngine, LLMEngineConfig,
                                          PrefixStore, StaticKVCache)
from paddle_tpu_torch.serving.llm import decode as tdec  # noqa: E402
from paddle_tpu_torch.serving.llm import kvcache as tkv  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16, 32), seed=3)
COMBOS = {"w8": ("int8", "float32"), "kv8": ("float32", "int8"),
          "w8kv8": ("int8", "int8")}
TOL = dict(rtol=1e-5, atol=1e-5)


def spread_weights(jm):
    """Random weights of a wider spread than the GPT's init (whose tiny
    logits give one token over and over), set on the JAX model; returns
    them as numpy arrays for the port's."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in jm.state_dict().items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        if v.ndim > 1:
            a *= 0.3
        else:
            a = a * 0.1 + (1.0 if "norm" in k and k.endswith("weight")
                           else 0.0)
        sd[k] = a.astype(np.float32)
    jm.set_state_dict(sd)
    return sd


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    sd = spread_weights(jm)
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    return jm, pm


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, MODEL["vocab_size"], n).astype(np.int32)
            for n in (5, 11, 20, 29)]


def _serve(engine, prompts=None, new=8):
    """Each prompt in turn (one request at a time), then drain."""
    try:
        return [engine.submit(p, max_new_tokens=new).result(120)["tokens"]
                for p in (prompts if prompts is not None else _prompts())]
    finally:
        engine.drain(timeout=60)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _codes_close(got, ref):
    """int8 codes of values computed by two packages' matmuls: equal but
    for an element that lands on a rounding boundary, off by one."""
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), d.mean())


# -- the int8 representation --------------------------------------------------

def test_quantize_kv_rows_byte_equal_jax():
    """One absmax scale per row over every leading index, zero rows at
    scale 1, and rows at exact halves: the same codes and scales byte for
    byte; dequantized within half a step of the input."""
    x = _rand(1, 3, 5, 4, 8)
    x[0, 1] = 0.0
    x[1, 2] = np.arange(32, dtype=np.float32).reshape(4, 8) / 127.0 - 0.5
    x[1, 2, 0, 0] = 1.0
    ref = jkv.quantize_kv_rows(jnp.asarray(x))
    got = tkv.quantize_kv_rows(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].shape == (3, 5)
    assert got["q"].numpy().tobytes() == np.asarray(ref["q"]).tobytes()
    assert got["s"].numpy().tobytes() == np.asarray(ref["s"]).tobytes()
    deq = tkv.dequantize_kv(got).numpy()
    np.testing.assert_allclose(deq, np.asarray(jkv.dequantize_kv(ref)),
                               rtol=2e-7, atol=1e-7)
    bound = np.abs(x).reshape(3, 5, -1).max(-1)[..., None, None] / 254
    assert np.all(np.abs(deq - x) <= bound + 1e-7)


def test_kv_helpers_and_dense_passthrough():
    """The dict helpers mirror the JAX package's on the same buffer; a
    dense buffer passes through ``dequantize_kv`` unchanged."""
    kv = StaticKVCache(2, 3, 8, 2, 4, kv_dtype="int8", device="cpu")
    jc = jkv.StaticKVCache(2, 3, 8, 2, 4, kv_dtype="int8")
    assert kv.quantized and kv.kv_dtype == "int8"
    assert tuple(kv.k["q"].shape) == jc.k["q"].shape == (2, 3, 8, 2, 4)
    assert tuple(kv.k["s"].shape) == jc.k["s"].shape == (2, 3, 8)
    assert tkv.kv_max_seq(kv.k) == jkv.kv_max_seq(jc.k) == 8
    view = tkv.kv_layer_view(kv.k, 1)
    assert tuple(view["q"].shape) == (2, 8, 2, 4)
    assert view["q"].data_ptr() == kv.k["q"][:, 1].data_ptr()
    assert tkv.kv_nbytes(kv.k) == jkv.kv_nbytes(jc.k)
    stacked = tkv.kv_stack_layers([tkv.kv_layer_view(kv.k, i)
                                   for i in range(3)])
    assert torch.equal(stacked["q"], kv.k["q"])
    dense = torch.ones(2, 3, 4)
    assert tkv.dequantize_kv(dense) is dense
    assert not tkv.is_quantized_kv(dense) and tkv.is_quantized_kv(kv.k)
    with pytest.raises(ValueError):
        StaticKVCache(1, 1, 4, 1, 2, kv_dtype="int4", device="cpu")


def test_int8_cache_reset_keeps_addresses_and_export_raises():
    kv = StaticKVCache(2, 1, 8, 1, 4, kv_dtype="int8", device="cpu")
    ptrs = [t.data_ptr() for t in (kv.k["q"], kv.k["s"], kv.v["q"],
                                   kv.v["s"])]
    kv.k["q"].fill_(3)
    kv.v["s"].fill_(2.0)
    kv.reset()
    assert [t.data_ptr() for t in (kv.k["q"], kv.k["s"], kv.v["q"],
                                   kv.v["s"])] == ptrs
    assert int(kv.k["q"].abs().sum()) == 0 and float(kv.v["s"].sum()) == 0
    with pytest.raises(NotImplementedError, match="int8 KV"):
        kv.host_slot_kv(0, 2)


def test_kv_memory_bar():
    """int8 KV holds at least 1.8x the sequences of fp32 KV in the same
    bytes (the JAX package's bar); the byte counts equal its caches'."""
    kw = dict(num_slots=8, num_layers=2, max_seq=64, num_heads=4,
              head_dim=8)
    dense = StaticKVCache(**kw, device="cpu")
    q = StaticKVCache(**kw, kv_dtype="int8", device="cpu")
    assert dense.kv_bytes() / q.kv_bytes() >= 1.8
    assert q.kv_bytes() == jkv.StaticKVCache(**kw, kv_dtype="int8").kv_bytes()


@pytest.mark.parametrize("positions", [[0, 3, 5], [7, 8, 30]],
                         ids=["inside", "at_and_past_max_seq"])
def test_int8_token_writer_byte_equal_jax(positions):
    """``append_token_kv`` over int8 layer views: codes and scales land
    where the JAX package's land them (clamped past ``max_seq``), in
    place, byte for byte."""
    base = _rand(0, 3, 8, 2, 4)
    kb = tkv.quantize_kv_rows(torch.from_numpy(base))
    vb = tkv.quantize_kv_rows(torch.from_numpy(base * 2))
    jkb = jkv.quantize_kv_rows(jnp.asarray(base))
    jvb = jkv.quantize_kv_rows(jnp.asarray(base * 2))
    kn, vn = _rand(2, 3, 2, 4), _rand(3, 3, 2, 4)
    pos = np.asarray(positions, np.int32)
    jk, jv = jkv.append_token_kv(jkb, jvb, jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos))
    out = tkv.append_token_kv(kb, vb, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pos))
    assert out[0] is kb
    for got, ref in ((kb, jk), (vb, jv)):
        for leaf in ("q", "s"):
            assert got[leaf].numpy().tobytes() == \
                np.asarray(ref[leaf]).tobytes()


@pytest.mark.parametrize("starts", [None, [0, 5, 2]],
                         ids=["prompt", "at_offsets"])
def test_int8_prompt_writer_byte_equal_jax(starts):
    """``write_prompt_kv`` / ``write_prompt_kv_at`` over an int8 cache:
    all layers of three requests in one write a leaf, byte for byte."""
    shape = (4, 2, 12, 2, 4)
    jc = {"q": jnp.zeros(shape, jnp.int8), "s": jnp.zeros(shape[:3])}
    tc = {"q": torch.zeros(shape, dtype=torch.int8),
          "s": torch.zeros(shape[:3])}
    jc2 = {"q": jc["q"], "s": jc["s"]}
    tc2 = {"q": tc["q"].clone(), "s": tc["s"].clone()}
    k_new, v_new = _rand(4, 3, 2, 6, 2, 4), _rand(5, 3, 2, 6, 2, 4)
    slots = [2, 0, 3]
    if starts is None:
        jk, jv = jkv.write_prompt_kv(jc, jc2, jnp.asarray(k_new),
                                     jnp.asarray(v_new), slots)
        tkv.write_prompt_kv(tc, tc2, torch.from_numpy(k_new),
                            torch.from_numpy(v_new), slots)
    else:
        jk, jv = jkv.write_prompt_kv_at(jc, jc2, jnp.asarray(k_new),
                                        jnp.asarray(v_new), slots, starts)
        tkv.write_prompt_kv_at(tc, tc2, torch.from_numpy(k_new),
                               torch.from_numpy(v_new), slots, starts)
    for got, ref in ((tc, jk), (tc2, jv)):
        for leaf in ("q", "s"):
            assert got[leaf].numpy().tobytes() == \
                np.asarray(ref[leaf]).tobytes()


def test_quantize_gpt_params_byte_equal_jax_and_in_place(models):
    """``quantize_gpt_params``: the six projection weights of each layer
    become int8 codes and per-out-channel scales byte-equal to the JAX
    package's, the rest stays the model's tensors; a decoder's second
    ``params()`` writes the same tensors in place."""
    jm, pm = models
    assert tdec._QUANT_WEIGHT_KEYS == jdec._QUANT_WEIGHT_KEYS
    jp = jdec.quantize_gpt_params(jdec.extract_gpt_params(jm))
    dec = GPTStaticDecoder(pm, weight_dtype="int8")
    tp = dec.params()
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for key in tdec._QUANT_WEIGHT_KEYS:
            assert tl[key]["q"].dtype == torch.int8
            assert tl[key]["q"].numpy().tobytes() == \
                np.asarray(jl[key]["q"]).tobytes()
            assert tl[key]["s"].numpy().tobytes() == \
                np.asarray(jl[key]["s"]).tobytes()
    assert tp["layers"][0]["n1w"] is pm.gpt.decoder.layers[0].norm1.weight
    assert tp["tok"] is pm.gpt.word_embeddings.weight
    again = dec.params()
    assert [t.data_ptr() for t in graphs._leaves(again)] == \
        [t.data_ptr() for t in graphs._leaves(tp)]


# -- the programs against the JAX package's -----------------------------------

def _params(models, w):
    jm, pm = models
    jp = jdec.extract_gpt_params(jm)
    if w == "int8":
        jp = jdec.quantize_gpt_params(jp)
    return jp, GPTStaticDecoder(pm, weight_dtype=w).params()


@pytest.mark.parametrize("combo", list(COMBOS))
def test_prefill_logits_and_rows_match_jax(models, combo):
    """One prefill of two right-padded prompts: the logits at 1e-5 and
    the cache rows it writes (dense at 1e-5; int8 codes equal but for a
    rounding boundary, scales at 1e-5)."""
    w, kvd = COMBOS[combo]
    jp, tp = _params(models, w)
    spec = GPTStaticDecoder(models[1]).spec
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9] = np.arange(9) * 7 % 64
    toks[1] = np.arange(16) * 13 % 64
    lens = np.asarray([9, 16], np.int32)
    jd = jdec.GPTStaticDecoder(models[0], max_top_k=0, weight_dtype=w,
                               kv_dtype=kvd)
    td = GPTStaticDecoder(models[1], max_top_k=0, weight_dtype=w,
                          kv_dtype=kvd)
    jc, tc = jd.new_kv(4, 32), td.new_kv(4, 32)
    key = jax.random.PRNGKey(0)
    jn, _ = jd.prefill(jc, jp, jnp.asarray(toks), jnp.asarray(lens),
                       jnp.asarray([1, 3], jnp.int32), jnp.zeros((4,), bool),
                       jdec.pack_sampling([jdec.SamplingParams()] * 2), key)
    tn, _ = td.prefill(tc, tp, torch.from_numpy(toks), torch.from_numpy(lens),
                       torch.tensor([1, 3], dtype=torch.int32),
                       torch.zeros(4, dtype=torch.bool),
                       tdec.pack_sampling([tdec.SamplingParams()] * 2, "cpu"),
                       None)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    with torch.no_grad():
        lraw, _, _ = tdec.prefill_forward(spec, tp, torch.from_numpy(toks),
                                          torch.from_numpy(lens))
    lp = toks.shape[1]
    h = jp["tok"][jnp.asarray(toks)] + jp["pos"][jnp.arange(lp)][None]
    mask = jnp.triu(jnp.full((lp, lp), -1e9, h.dtype), 1)[None, None]
    for layer in jp["layers"]:
        h, _, _ = jdec._block_prefill(spec, layer, h, mask,
                                      1.0 / np.sqrt(spec.head_dim))
    h = jdec._layer_norm(h, jp["fnw"], jp["fnb"], spec.ln_epsilon)
    ref = h[jnp.arange(2), jnp.asarray(lens) - 1] @ jp["tok"].T
    np.testing.assert_allclose(lraw.numpy(), np.asarray(ref), **TOL)
    _rows_close(tc, jc)


def _rows_close(tc, jc):
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        if isinstance(got, dict):
            _codes_close(got["q"].numpy(), np.asarray(ref["q"]))
            np.testing.assert_allclose(got["s"].numpy(),
                                       np.asarray(ref["s"]), **TOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _jax_decode_logits(spec, params, kbuf, vbuf, lengths, last):
    """The forward half of the JAX package's decode step, over dense or
    int8 buffers (its step returns no logits of its own)."""
    scale = 1.0 / np.sqrt(spec.head_dim)
    posc = jnp.clip(lengths, 0, spec.max_position_embeddings - 1)
    h = params["tok"][last] + params["pos"][posc]
    mask = jkv.valid_mask(lengths, jkv.kv_max_seq(kbuf), h.dtype)
    for li, lp in enumerate(params["layers"]):
        h, _, _ = jdec._block_decode(spec, lp, h, jkv.kv_layer_view(kbuf, li),
                                     jkv.kv_layer_view(vbuf, li), lengths,
                                     mask, scale)
    h = jdec._layer_norm(h, params["fnw"], params["fnb"], spec.ln_epsilon)
    return np.asarray(h @ params["tok"].T)


@pytest.mark.parametrize("combo", list(COMBOS))
def test_decode_step_logits_and_rows_match_jax(models, combo):
    """One decode step from the same random cache state (int8 state made
    by each package's ``quantize_kv_rows``, byte-equal) with a free slot
    past ``max_seq``: the logits at 1e-5, the tokens equal, the rows
    written as the JAX package writes them."""
    w, kvd = COMBOS[combo]
    jp, tp = _params(models, w)
    jd = jdec.GPTStaticDecoder(models[0], max_top_k=0, weight_dtype=w,
                               kv_dtype=kvd)
    td = GPTStaticDecoder(models[1], max_top_k=0, weight_dtype=w,
                          kv_dtype=kvd)
    spec = td.spec
    jc, tc = jd.new_kv(4, 32), td.new_kv(4, 32)
    shape = (4, spec.num_layers, 32, spec.num_heads, spec.head_dim)
    k0, v0 = _rand(8, *shape, scale=0.5), _rand(9, *shape, scale=0.5)
    if kvd == "int8":
        jc.k, jc.v = jkv.quantize_kv_rows(jnp.asarray(k0)), \
            jkv.quantize_kv_rows(jnp.asarray(v0))
        for buf, x in ((tc.k, k0), (tc.v, v0)):
            q = tkv.quantize_kv_rows(torch.from_numpy(x))
            buf["q"].copy_(q["q"])
            buf["s"].copy_(q["s"])
    else:
        jc.k, jc.v = jnp.asarray(k0), jnp.asarray(v0)
        tc.k.copy_(torch.from_numpy(k0))
        tc.v.copy_(torch.from_numpy(v0))
    lengths = np.asarray([3, 35, 17, 31], np.int32)
    jc.lengths = jnp.asarray(lengths)
    tc.lengths.copy_(torch.from_numpy(lengths))
    last = np.asarray([5, 7, 1, 60], np.int32)
    ref = _jax_decode_logits(spec, jp, jc.k, jc.v, jc.lengths,
                             jnp.asarray(last))
    logits = td.decode_logits(tc, tp, torch.from_numpy(last))
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)
    tc.lengths.copy_(torch.from_numpy(lengths))      # logits wrote rows
    jn, _ = jd.decode_step(jc, jp, jnp.zeros((4,), bool), jnp.asarray(last),
                           jdec.pack_sampling([jdec.SamplingParams()] * 4),
                           jax.random.PRNGKey(0))
    tn, _ = td.decode_step(tc, tp, torch.zeros(4, dtype=torch.bool),
                           torch.from_numpy(last),
                           tdec.pack_sampling([tdec.SamplingParams()] * 4,
                                              "cpu"), None)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tc.host_lengths().tolist() == np.asarray(jc.lengths).tolist()
    _rows_close(tc, jc)


# -- the engines --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tokens(models):
    out = {}
    for combo, (w, kvd) in COMBOS.items():
        out[combo] = _serve(JLLMEngine(models[0], JConfig(
            **ENGINE, weight_dtype=w, kv_dtype=kvd)))
    return out


@pytest.mark.parametrize("lane", ["graphed", "eager"])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_slot_engine_gives_the_jax_engines_tokens(models, jax_tokens, combo,
                                                  lane):
    """The slot engine with int8 weights, int8 KV or both: the JAX
    engine's greedy tokens on every request, through the compiled
    programs (one decode trace) and on the eager lane."""
    w, kvd = COMBOS[combo]
    cache = ExecutableCache()
    cfg = LLMEngineConfig(**ENGINE, weight_dtype=w, kv_dtype=kvd)
    if lane == "eager":
        with graphs.disable_graphs():
            eng = LLMEngine(models[1], cfg, cache=cache)
            toks = _serve(eng)
    else:
        eng = LLMEngine(models[1], cfg, cache=cache)
        toks = _serve(eng)
        assert eng.decoder.decode_fn(4, 64).trace_counter["traces"] == 1
    assert toks == jax_tokens[combo]
    assert len({t for r in toks for t in r}) > 3
    kv = eng._batcher.kv
    assert kv.quantized == (kvd == "int8")
    assert eng.stats()["kv_bytes"] == kv.kv_bytes()


def test_int8_weights_with_prefix_reuse_give_the_jax_engines_tokens(models):
    """int8 weights under prefix reuse (the reference's combination: the
    tail prefill goes through ``_mm``): each prompt twice, the second
    pass hitting the store; tokens and hits equal the JAX engine's."""
    prompts = _prompts()
    prompts[2][:8] = prompts[1][:8]
    kw = dict(ENGINE, weight_dtype="int8", prefix_cache=True, prefix_block=4)
    ref = _serve(JLLMEngine(models[0], JConfig(**kw)), prompts * 2)
    eng = LLMEngine(models[1], LLMEngineConfig(**kw),
                    cache=ExecutableCache())
    got = _serve(eng, prompts * 2)
    assert got == ref
    assert eng.stats()["stats"]["serving.llm.prefix.hits"] >= 4


# -- gates --------------------------------------------------------------------

@pytest.mark.parametrize("kw,engine_kw,match", [
    (dict(kv_dtype="int8", prefix_cache=True), {}, "prefix_cache"),
    (dict(kv_dtype="int8", spec_k=2), {}, "spec"),
    (dict(kv_dtype="int8"), {"prefix_store": True}, "dense KV"),
], ids=["prefix_int8_kv", "spec_int8_kv", "shared_store_int8_kv"])
def test_int8_kv_gates_raise_as_jax(models, kw, engine_kw, match):
    """The reference's refusals over int8 KV, in both packages."""
    jm, pm = models
    cfg = dict(num_slots=2, max_seq=32, prefill_buckets=(8,), warmup=False)
    from paddle_tpu.serving.llm.prefix import PrefixStore as JPrefixStore
    for eng_cls, cfg_cls, store in ((JLLMEngine, JConfig, JPrefixStore),
                                    (LLMEngine, LLMEngineConfig,
                                     PrefixStore)):
        extra = {"prefix_store": store()} if engine_kw else {}
        model = jm if eng_cls is JLLMEngine else pm
        with pytest.raises(ValueError, match=match):
            eng_cls(model, cfg_cls(**cfg, **kw), **extra)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_spec_over_int8_weights_refused_where_jax_fails(models, layout):
    """The JAX package takes ``spec_k > 0`` with int8 weights, and its
    verify then multiplies the quantized dict as a matrix: a TypeError at
    the first spec step (the warm-up's). The port refuses the config at
    construction, naming the cause, and adds no int8 verify."""
    jm, pm = models
    cfg = dict(num_slots=2, max_seq=32, prefill_buckets=(8,), spec_k=2,
               weight_dtype="int8", kv_layout=layout, page_size=8)
    with pytest.raises(TypeError):
        JLLMEngine(jm, JConfig(**cfg), draft_model=jm)
    with pytest.raises(ValueError, match="weight_dtype='float32' or spec_k"):
        LLMEngine(pm, LLMEngineConfig(**cfg), draft_model=pm)


def test_prefix_paths_over_int8_kv_raise_as_jax(models):
    jm, pm = models
    td = GPTStaticDecoder(pm, kv_dtype="int8")
    kv = td.new_kv(1, 16)
    jd = jdec.GPTStaticDecoder(jm, kv_dtype="int8")
    jc = jd.new_kv(1, 16)
    pre = np.zeros((2, 4, 4, 8), np.float32)
    for dec, cache in ((jd, jc), (td, kv)):
        with pytest.raises(NotImplementedError):
            dec.insert_prefix(cache, pre, pre, 0)
        with pytest.raises(NotImplementedError):
            dec.tail_prefill(cache, dec.params(), *([None] * 7))


def test_decoder_dtypes_validated_and_keys_apart(models):
    _, pm = models
    with pytest.raises(ValueError):
        GPTStaticDecoder(pm, weight_dtype="fp8")
    with pytest.raises(ValueError):
        GPTStaticDecoder(pm, kv_dtype="int4")
    cache = ExecutableCache()
    keys = {GPTStaticDecoder(pm, exec_cache=cache, weight_dtype=w,
                             kv_dtype=k)._key
            for w in ("float32", "int8") for k in ("float32", "int8")}
    assert len(keys) == 4


def test_requantized_weights_reach_a_captured_program(models):
    """The decode program binds the weights' addresses at its first call.
    After an in-place change of the model's weights, the decoder's
    ``params()`` re-quantizes into the same tensors: the program takes
    them (no moved-weights error) and its next step equals a fresh
    decoder's on the new weights."""
    _, pm0 = models
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(pm0.state_dict())
    dec = GPTStaticDecoder(pm, max_top_k=0, weight_dtype="int8",
                           kv_dtype="int8", exec_cache=ExecutableCache())
    kv = dec.new_kv(2, 32)
    p1 = dec.params()
    fin = torch.zeros(2, dtype=torch.bool)
    samp = tdec.pack_sampling([tdec.SamplingParams()] * 2, "cpu")
    last = torch.tensor([3, 9], dtype=torch.int32)
    dec.decode_step(kv, p1, fin, last, samp, None)
    with torch.no_grad():
        for p in pm.parameters():
            p.mul_(-1.5)
    p2 = dec.params()
    assert [t.data_ptr() for t in graphs._leaves(p2)] == \
        [t.data_ptr() for t in graphs._leaves(p1)]
    fresh = GPTStaticDecoder(pm, max_top_k=0, weight_dtype="int8",
                             kv_dtype="int8", exec_cache=ExecutableCache())
    kv2 = fresh.new_kv(2, 32)
    for a, b in zip(tkv.kv_leaves(kv2.k) + tkv.kv_leaves(kv2.v),
                    tkv.kv_leaves(kv.k) + tkv.kv_leaves(kv.v)):
        a.copy_(b)
    kv2.lengths.copy_(kv.lengths)
    ref = fresh.decode_logits(kv2, fresh.params(), last)
    assert torch.equal(dec.decode_logits(kv, p2, last), ref)
    got, _ = dec.decode_step(kv, p2, fin, last, samp, None)
    assert torch.equal(got, ref.argmax(-1).to(torch.int32))
    assert dec.decode_fn(2, 32).trace_counter["traces"] == 1
