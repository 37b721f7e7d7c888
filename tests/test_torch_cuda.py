"""The port's CUDA kernels on the card: each kernel against its plain
version (B1-B3 in float32, bfloat16 and float16), the wrappers' refusals
(no fallback on a CUDA tensor), the GPT forward, an O1 bfloat16 train step
and the paged engine through the kernels at a small size, ``generate`` in
its three cache modes and the default static-slot engine against the CPU,
and the YOLOv3 detection path (greedy NMS on the card against the CPU).

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on a machine with a card but
without jax it runs on its own, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops import custom as tcustom
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

MODEL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=512, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


def _paged_case(seed, s_n=4, h=4, d=32, page=16, pps=8, layers=2):
    """A multi-layer arena (so the layer view is strided), block tables
    mixing real pages and the trash page, positions at 0, on page edges
    and past the table."""
    rng = np.random.default_rng(seed)
    n_pages = s_n * pps
    shape = (n_pages + 1, layers, page, h, d)
    arena_k = rng.standard_normal(shape, dtype=np.float32)
    arena_v = rng.standard_normal(shape, dtype=np.float32)
    bt = rng.permutation(n_pages).reshape(s_n, pps).astype(np.int32)
    bt[rng.random((s_n, pps)) < 0.25] = n_pages
    positions = np.array([0, page - 1, page, pps * page + 3][:s_n], np.int32)
    q = rng.standard_normal((s_n, h, d), dtype=np.float32)
    return q, arena_k, arena_v, bt, positions


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 128, 128, 4, 64, True),
                                   (1, 100, 100, 2, 128, True),
                                   (2, 48, 130, 2, 32, True),
                                   (2, 64, 200, 2, 32, False),
                                   (2, 128, 128, 12, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, shape):
    b, sq, skv, h, d, causal = shape
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(6, b, sq, skv, h, d))
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert tfa.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as column slices of one fused projection, as a caller with a
    packed QKV would pass them: read through strides, never copied."""
    b, s, h, d = 2, 96, 2, 64
    qkv = torch.randn(b, s, 3 * h * d, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q)


def _max_rel(got, ref):
    """max |got - ref| / max |ref|, in float64."""
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [
    (1, 1, 32), (15, 17, 64), (17, 15, 128), (16, 16, 32), (16, 65, 64),
    (65, 16, 128), (63, 65, 32), (65, 63, 64), (64, 64, 128), (1, 100, 32),
    (100, 1, 64), (100, 1000, 128), (1000, 100, 32), (1, 1000, 64),
    (1000, 1, 128), (1000, 1000, 64)])
def test_flash_forward_kernel_at_tile_edges(cuda, dtype, causal, sq, skv,
                                            d):
    """Lengths at and around B1's 64-row tiles, Sq != Skv both ways. fp32
    (3xTF32 on the tensor cores) is held to 1e-4 of the plain version and
    to 2e-5 of the same attention in float64 (max |err| / max |ref|, O
    and LSE); bf16 to 2e-2 of the plain version (O) and 1e-4 (LSE)."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(sq + skv + d, 1, sq, skv, 2, d))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    if dtype == torch.float32:
        o64, l64 = tfa.flash_attention_fwd_plain(
            *(x.double() for x in (q, k, v)), causal)
        errs = (_max_rel(out, o64), _max_rel(lse, l64))
        assert max(errs) <= 2e-5, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_kernel_is_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(10, 2, 1000, 1000, 4, 128))
    first = tfa.flash_attention_fwd(q, k, v, causal=True)
    second = tfa.flash_attention_fwd(q, k, v, causal=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_forward_kernel_refuses_misaligned_rows(cuda):
    """B1 loads tiles 16 bytes at a time, as B2/B3 do: a row stride or a
    base pointer that is not a multiple of 16 bytes raises."""
    q, k, v = (torch.from_numpy(x).to(cuda) for x in _qkv(11, 2, 32, 32, 2,
                                                          64))
    b, s, h, d = q.shape
    buf = torch.zeros(b * s * (h * d + 1), device=cuda)
    odd = buf.as_strided(q.shape, (s * (h * d + 1), h * d + 1, d, 1))
    odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_fwd(odd, k, v, causal=True)
    shifted = torch.zeros(v.numel() + 1, device=cuda)[1:].view(v.shape)
    shifted.copy_(v)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_fwd(q, k, shifted)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)])
@pytest.mark.parametrize("d", [32, 64, 128, 16, 48, 80, 96, 160, 256,
                               100, 130, 36, 7, 1, 512, 1024])
def test_paged_kernel_matches_plain(cuda, dtype, tol, d):
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(7, d=d))
    q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt, pos)
    ref = tpa.paged_attention_plain(q, ak[:, 1], av[:, 1], bt, pos)
    assert tpa.paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-3)])
def test_paged_kernel_splits_a_long_sequence_into_many_chunks(cuda, dtype,
                                                              tol):
    """Two sequences of 256 pages of 4 rows, 4 (sequence, head) pairs: the
    chunk rule gives one page per chunk, so the 1024 visible rows of the
    first sequence are merged from 256 chunks in the same launch."""
    q, ak, av, bt, _ = _paged_case(12, s_n=2, h=2, d=64, page=4, pps=256)
    pos = np.array([1023, 700], np.int32)
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in (q, ak, av, bt, pos))
    q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tpa.chunk_pages_for(256, 4, n_sms) == 1
    out = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt, pos)
    ref = tpa.paged_attention_plain(q, ak[:, 1], av[:, 1], bt, pos)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_paged_kernel_position_zero_and_all_trash_tables(cuda):
    """Position 0 sees the first row only; a table that is all the
    engine's trash page (index P, inside the arena) reads it as the plain
    version does; a table whose entries all lie outside the arena sees no
    row and gets exactly 0, with no NaN from merging its 51 chunks of
    l = 0."""
    q, ak, av, bt, _ = _paged_case(13, s_n=3, h=2, d=32, page=4, pps=64)
    n_pages = ak.shape[0] - 1
    bt[0, 0] = 7
    bt[1] = -1
    bt[2] = n_pages
    pos = np.array([0, 200, 255], np.int32)
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in (q, ak, av, bt, pos))
    out = tpa.paged_attention(q, ak[:, 0], av[:, 0], bt, pos)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(out[0], av[7, 0, 0], rtol=1e-6, atol=1e-6)
    keep = [0, 2]
    ref = tpa.paged_attention_plain(q[keep], ak[:, 0], av[:, 0], bt[keep],
                                    pos[keep])
    torch.testing.assert_close(out[keep], ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_kernel_is_deterministic(cuda, dtype):
    """No float atomics: the chunks merge in chunk order whichever block
    finishes last, so two launches agree bit for bit."""
    q, ak, av, bt, _ = _paged_case(14, s_n=8, h=16, d=128, page=16, pps=64)
    pos = np.array([1023, 15, 16, 255, 512, 1023, 640, 1000], np.int32)
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in (q, ak, av, bt, pos))
    q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
    first = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt, pos)
    for _ in range(3):
        assert torch.equal(tpa.paged_attention(q, ak[:, 1], av[:, 1], bt,
                                               pos), first)


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    """int64 tables, float64 and mixed types, and heads past 1024 raise;
    nothing the kernel does not take is served another way."""
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(8))
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(q, ak[:, 0], av[:, 0], bt.long(), pos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.double(), ak[:, 0].double(),
                            av[:, 0].double(), bt, pos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), ak[:, 0], av[:, 0], bt, pos)
    for d, dtype in ((1032, torch.float32), (1040, torch.bfloat16)):
        q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                              for x in _paged_case(8, s_n=2, h=1, d=d,
                                                   pps=2))
        q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            tpa.paged_attention(q, ak[:, 0], av[:, 0], bt, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_paged_kernel_reads_views_off_16_bytes(cuda, dtype):
    """A query and an arena shifted one element off 16 bytes load one
    element a lane and agree with the plain version, as do rows cut to
    60 of their 64 elements (strided rows, whole 16-byte vectors in
    float32 only)."""
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(8, d=64))
    q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    shifted = torch.zeros(q.numel() + 1, dtype=dtype,
                          device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    ks = torch.zeros(ak.numel() + 1, dtype=dtype,
                     device=cuda)[1:].view(ak.shape)
    ks.copy_(ak)
    ref = tpa.paged_attention_plain(q, ak[:, 0], av[:, 0], bt, pos)
    for args in ((shifted, ak[:, 0], av[:, 0]), (q, ks[:, 0], av[:, 0]),
                 (q[..., :60], ak[:, 0, ..., :60], av[:, 0, ..., :60])):
        before = tpa.paged_attention.launches
        out = tpa.paged_attention(*args, bt, pos)
        assert tpa.paged_attention.launches == before + 1
        want = ref if args[1].shape[-1] == 64 else \
            tpa.paged_attention_plain(*args, bt, pos)
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_gpt_forward_through_flash_kernel(cuda):
    model = GPTForCausalLM(GPTConfig(**MODEL, attn_impl="flash"),
                           device=cuda, seed=0).eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, MODEL["vocab_size"], (3, 40))).to(cuda)
    before = tfa.flash_attention_fwd.launches
    with torch.no_grad():
        flash = model(ids)
        model.set_attn_impl("dense")
        dense = model(ids)
    assert tfa.flash_attention_fwd.launches == before + MODEL["num_layers"]
    torch.testing.assert_close(flash, dense, rtol=1e-4, atol=1e-4)


def test_paged_engine_kernel_lane_matches_gather_lane(cuda):
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], n).tolist()
               for n in (5, 7, 10)]
    tokens = {}
    for impl in ("kernel", "gather"):
        before = tpa.paged_attention.launches      # warmup launches count
        eng = LLMEngine(model, LLMEngineConfig(
            num_slots=4, max_seq=64, kv_layout="paged", page_size=4,
            prefill_buckets=(8, 16), paged_attn_impl=impl))
        try:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            tokens[impl] = [r.result(timeout=120)["tokens"] for r in reqs]
        finally:
            eng.drain(timeout=60)
        launched = tpa.paged_attention.launches - before
        stats = eng.stats()["stats"]
        steps = (stats["serving.llm.decode_ticks"]
                 + stats["serving.llm.warmup_decode_steps"])
        assert launched == (MODEL["num_layers"] * steps
                            if impl == "kernel" else 0)
    assert tokens["kernel"] == tokens["gather"]
    assert all(len(t) == 8 for t in tokens["kernel"])


def test_default_paged_engine_serves_head_dim_80_through_the_kernel(cuda):
    """head_dim 80 (GPT-3 2.7B's): the default engine config ("auto")
    serves the model through the paged kernel, one launch a layer a step,
    with the tokens of the gather lane; head_dim 130 (rows of 520 bytes)
    takes the kernel too, and a model whose heads the kernel does not
    take (head_dim 1040, past 1024) raises on "auto" and "kernel" alike
    and is served only on an explicit gather lane."""
    cfg = dict(MODEL, hidden_size=160, num_heads=2, intermediate_size=640)
    model = GPTForCausalLM(GPTConfig(**cfg), device=cuda, seed=0).eval()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist()
               for n in (5, 7, 10)]
    tokens = {}
    for impl, lane in (("kernel", {}), ("gather", {"paged_attn_impl":
                                                   "gather"})):
        before = tpa.paged_attention.launches
        eng = LLMEngine(model, LLMEngineConfig(
            num_slots=4, max_seq=64, kv_layout="paged", page_size=4,
            prefill_buckets=(8, 16), **lane))
        assert eng.decoder.attn_impl == impl
        try:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            tokens[impl] = [r.result(timeout=120)["tokens"] for r in reqs]
        finally:
            eng.drain(timeout=60)
        launched = tpa.paged_attention.launches - before
        stats = eng.stats()["stats"]
        steps = (stats["serving.llm.decode_ticks"]
                 + stats["serving.llm.warmup_decode_steps"])
        assert launched == (cfg["num_layers"] * steps
                            if impl == "kernel" else 0)
    assert tokens["kernel"] == tokens["gather"]
    assert all(len(t) == 8 for t in tokens["kernel"])
    odd = GPTForCausalLM(GPTConfig(**dict(cfg, hidden_size=260)),
                         device=cuda, seed=0).eval()
    for impl in ("auto", "kernel"):
        assert GPTPagedDecoder(odd, page_size=4,
                               attn_impl=impl).attn_impl == "kernel"
    wide = GPTForCausalLM(GPTConfig(**dict(cfg, hidden_size=1040,
                                           num_heads=1)),
                          device=cuda, seed=0).eval()
    for impl in ("auto", "kernel"):
        with pytest.raises(ValueError, match="head_dim 1040"):
            GPTPagedDecoder(wide, page_size=4, attn_impl=impl)
    assert GPTPagedDecoder(wide, page_size=4,
                           attn_impl="gather").attn_impl == "gather"


@pytest.mark.parametrize("dtype,cfg", [
    (torch.float16, MODEL),
    (torch.bfloat16, dict(MODEL, hidden_size=200, num_heads=2,
                          intermediate_size=800))],
    ids=["float16_head_dim_32", "bfloat16_head_dim_100"])
def test_default_paged_engine_serves_float16_and_head_dim_100_through_the_kernel(
        cuda, dtype, cfg):
    """A float16 model and 200-byte bfloat16 rows (head_dim 100): the
    default engine ("auto") serves both through the paged kernel, one
    launch a layer a step, with an explicit gather engine's tokens."""
    model = GPTForCausalLM(GPTConfig(**cfg), device=cuda,
                           seed=0).eval().to(dtype)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist()
               for n in (5, 7, 10)]
    tokens = {}
    for lane in ("kernel", "gather"):
        before = tpa.paged_attention.launches
        eng = LLMEngine(model, LLMEngineConfig(
            num_slots=4, max_seq=64, kv_layout="paged", page_size=4,
            prefill_buckets=(8, 16),
            **({} if lane == "kernel" else {"paged_attn_impl": lane})))
        assert eng.decoder.attn_impl == lane
        try:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            tokens[lane] = [r.result(timeout=120)["tokens"] for r in reqs]
        finally:
            eng.drain(timeout=60)
        stats = eng.stats()["stats"]
        steps = (stats["serving.llm.decode_ticks"]
                 + stats["serving.llm.warmup_decode_steps"])
        assert tpa.paged_attention.launches - before == (
            cfg["num_layers"] * steps if lane == "kernel" else 0)
    assert tokens["kernel"] == tokens["gather"]
    assert all(len(t) == 8 for t in tokens["kernel"])


def _cpu_twin(model):
    twin = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin


def test_generate_on_the_card_matches_the_cpu(cuda):
    """``generate`` in all three cache modes on the card gives the same
    model's CPU tokens; the recompute lane launches B1 once a layer a
    step, the static and concat lanes never."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    ids = np.random.default_rng(2).integers(0, MODEL["vocab_size"], (2, 9))
    ref = _cpu_twin(model).generate(ids, max_length=12).numpy()
    for use_cache in (True, "concat", False):
        before = tfa.flash_attention_fwd.launches
        out = model.generate(ids, max_length=12, use_cache=use_cache)
        launched = tfa.flash_attention_fwd.launches - before
        assert out.device.type == "cuda" and out.dtype == torch.int32
        np.testing.assert_array_equal(out.cpu().numpy(), ref)
        assert launched == (MODEL["num_layers"] * 12
                            if use_cache is False else 0)


def test_generate_past_the_position_table_on_the_card(cuda):
    """Positions past the table embed as NaN (the JAX package's gather)
    instead of indexing past it, which on CUDA is a device-side assert:
    the call returns the CPU's tokens, and the card is usable after."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    n_pos = MODEL["max_position_embeddings"]
    ids = np.random.default_rng(4).integers(0, MODEL["vocab_size"],
                                            (2, n_pos - 5))
    ref = _cpu_twin(model).generate(ids, max_length=8).numpy()
    for use_cache in (True, "concat", False):
        out = model.generate(ids, max_length=8, use_cache=use_cache)
        np.testing.assert_array_equal(out.cpu().numpy(), ref)
    torch.cuda.synchronize()
    assert torch.ones(2, device=cuda).sum().item() == 2.0


def test_slot_decode_with_a_free_slot_past_max_seq(cuda):
    """Every slot advances every tick, free ones included: a slot whose
    length is past max_seq writes its last row (clamped) instead of a
    device-side assert, and the live slots' logits are unchanged."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    dec = GPTStaticDecoder(model)
    kv, params = dec.new_kv(3, 16), dec.params()
    toks = torch.arange(1, 9, dtype=torch.int32, device=cuda)[None]
    samp = pack_sampling([SamplingParams()], cuda)
    fin = torch.zeros(3, dtype=torch.bool, device=cuda)
    nxt, fin = dec.prefill(kv, params, toks,
                           torch.tensor([6], dtype=torch.int32, device=cuda),
                           torch.tensor([0], dtype=torch.int32, device=cuda),
                           fin, samp, None)
    last = torch.stack([nxt[0], nxt[0], nxt[0]]).to(torch.int32)
    live = dec.decode_logits(kv, params, last)[0]
    kv.lengths[1] = 16
    kv.lengths[2] = 1000
    torch.testing.assert_close(dec.decode_logits(kv, params, last)[0], live,
                               rtol=0, atol=0)
    samp3 = pack_sampling([SamplingParams()] * 3, cuda)
    for _ in range(3):
        last, fin = dec.decode_step(kv, params, fin, last, samp3, None)
    assert kv.host_lengths().tolist() == [9, 19, 1003]
    assert torch.isfinite(live).all()


def test_default_engine_serves_the_slot_layout_on_the_card(cuda):
    """``LLMEngine(model)`` with no ``kv_layout``: the static-slot
    decoder on the card, with the CPU model's tokens."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 20))]
    eng = LLMEngine(model, LLMEngineConfig(num_slots=4, max_seq=64))
    assert isinstance(eng.decoder, GPTStaticDecoder)
    assert eng.stats()["kv_layout"] == "slot"
    try:
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        tokens = [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        eng.drain(timeout=60)
    twin = _cpu_twin(model)
    for p, t in zip(prompts, tokens):
        ref = twin.generate(np.array([p]), max_length=8).numpy()[0]
        assert t == ref[len(p):].tolist()


def _bwd_case(cuda, dtype, b, sq, skv, h, d, causal, seed=9):
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype) for x in
                   (*_qkv(seed, b, sq, skv, h, d),
                    np.random.default_rng(seed + 1).standard_normal(
                        (b, sq, h, d), dtype=np.float32)))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    return q, k, v, do, out, lse, tfa.attention_delta(out, do)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 128, 128, 4, 64, True),
                                   (1, 100, 100, 2, 128, True),
                                   (2, 48, 130, 2, 32, True),
                                   (2, 130, 48, 2, 32, True),
                                   (2, 64, 200, 2, 32, False),
                                   (2, 128, 128, 12, 64, False)])
def test_flash_backward_kernels_match_plain(cuda, dtype, tol, shape):
    b, sq, skv, h, d, causal = shape
    q, k, v, do, out, lse, delta = _bwd_case(cuda, dtype, *shape)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                        delta=delta)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == dtype
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * scale)


def _rel_errs(got, ref):
    """max |got - ref| / max |ref| per gradient. A gradient that is zero
    but for rounding (every query sees one key, so dS = 0) is held to the
    scale of the largest of the three instead."""
    top = max(float(r.abs().max()) for r in ref)
    errs = []
    for g, r in zip(got, ref):
        m = float(r.abs().max())
        errs.append(float((g.double() - r.double()).abs().max())
                    / (m if m > 1e-3 * top else top))
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [
    (1, 1, 32), (63, 65, 64), (65, 63, 128), (127, 129, 32),
    (129, 127, 64), (1000, 129, 128), (129, 1000, 32), (1, 1000, 64),
    (1000, 1, 128), (1000, 1000, 64)])
def test_flash_backward_kernels_at_tile_edges(cuda, dtype, causal, sq, skv,
                                              d):
    """Lengths at and around the kernels' 64-row tiles, Sq != Skv both
    ways. fp32 (3xTF32 on the tensor cores) is held to 1e-4 of the plain
    version and to 2e-5 of the same formulas in float64; bf16 to 2e-2 of
    the plain version."""
    q, k, v, do, out, lse, delta = _bwd_case(cuda, dtype, 1, sq, skv, 2, d,
                                             causal, seed=sq + skv + d)
    args = (q, k, v, do, lse, delta, causal)
    got = (tfa.flash_attention_bwd_dq(*args),
           *tfa.flash_attention_bwd_dkv(*args))
    plain = (tfa.flash_attention_bwd_dq_plain(*args),
             *tfa.flash_attention_bwd_dkv_plain(*args))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    errs = _rel_errs([g.float() for g in got], [p.float() for p in plain])
    assert max(errs) <= tol, errs
    if dtype == torch.float32:
        f64 = [x.double() for x in (q, k, v, do)]
        o64, l64 = tfa.flash_attention_fwd_plain(*f64[:3], causal)
        r64 = tfa.flash_attention_bwd_plain(*f64[:3], o64, l64, f64[3],
                                            causal)
        errs = _rel_errs(got, r64)
        assert max(errs) <= 2e-5, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs agree bit for bit."""
    q, k, v, do, out, lse, delta = _bwd_case(cuda, dtype, 2, 1000, 1000, 4,
                                             128, True)
    args = (q, k, v, do, lse, delta, True)
    first = (tfa.flash_attention_bwd_dq(*args),
             *tfa.flash_attention_bwd_dkv(*args))
    second = (tfa.flash_attention_bwd_dq(*args),
              *tfa.flash_attention_bwd_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_backward_kernels_refuse_misaligned_rows(cuda):
    """The tiles load 16 bytes at a time: a row stride or a base pointer
    that is not a multiple of 16 bytes raises, with no scalar fallback."""
    q, k, v, do, out, lse, delta = _bwd_case(cuda, torch.float32, 2, 32, 32,
                                             2, 64, True)
    b, s, h, d = q.shape
    buf = torch.zeros(b * s * (h * d + 1), device=cuda)
    odd = buf.as_strided(q.shape, (s * (h * d + 1), h * d + 1, d, 1))
    odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bwd_dq(odd, k, v, do, lse, delta, True)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bwd_dkv(q, odd, v, do, lse, delta, True)
    shifted = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(do)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bwd_dkv(q, k, v, shifted, lse, delta, True)


def test_flash_backward_kernels_read_strided_inputs_and_grad_dtypes(cuda):
    """q/k/v/dO as column slices of packed tensors, read through strides;
    f32 gradients from bf16 inputs (the ring-flash grad_dtypes contract)."""
    b, s, h, d = 2, 96, 2, 64
    qkv = torch.randn(b, s, 3 * h * d, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, 2 * h * d, device=cuda)[..., :h * d].reshape(
        b, s, h, d)
    assert not q.is_contiguous() and not do.is_contiguous()
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
    out, lse = tfa.flash_attention_fwd(qb, kb, vb, causal=True)
    f32 = (torch.float32,) * 3
    got = tfa.flash_attention_bwd(qb, kb, vb, out, lse, dob, True,
                                  grad_dtypes=f32)
    want = tfa.flash_attention_bwd_plain(qb, kb, vb, out, lse, dob, True,
                                         grad_dtypes=f32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_flash_backward_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, do, out, lse, delta = _bwd_case(cuda, torch.float32, 1, 32, 32,
                                             2, 64, True)
    with pytest.raises(TypeError, match="gradient dtype"):
        tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                   dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                    delta.transpose(1, 2).contiguous()
                                    .transpose(1, 2), True)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd_dq(q, k, v, do.to(torch.bfloat16), lse,
                                   delta, True)
    q96 = torch.zeros(1, 8, 2, 96, device=cuda)
    lse96 = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bwd_dkv(q96, q96, q96, q96, lse96, lse96)


def test_train_batch_through_flash_kernels_matches_dense(cuda):
    """One AdamW train_batch of a 2-layer GPT on the card: the flash step
    launches B1, B2 and B3 once per layer, and its loss, gradients and
    updated weights equal the dense-attention step's."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    ids = np.random.default_rng(2).integers(0, MODEL["vocab_size"], (3, 64))
    res = {}
    for impl in ("flash", "dense"):
        counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                    tfa.flash_attention_bwd_dkv)
        before = [c.launches for c in counters]
        net = GPTForCausalLM(GPTConfig(**MODEL, attn_impl=impl),
                             device=cuda, seed=0)
        model = Model(net)
        model.prepare(AdamW(learning_rate=1e-3, parameters=net.parameters(),
                            epsilon=1e-6, grad_clip=ClipGradByGlobalNorm(1.0)),
                      GPTPretrainingCriterion())
        model.train_batch([ids], [ids], update=False)
        grads = {n: p.grad.clone() for n, p in net.named_parameters()}
        net.zero_grad(set_to_none=True)
        loss, _ = model.train_batch([ids], [ids])
        launched = [c.launches - b for c, b in zip(counters, before)]
        res[impl] = (loss, grads, {n: p.detach().clone()
                                   for n, p in net.named_parameters()})
        want = 2 * MODEL["num_layers"] if impl == "flash" else 0
        assert launched == [want] * 3, (impl, launched)
    assert abs(res["flash"][0] - res["dense"][0]) < 1e-4
    for n, g in res["dense"][1].items():
        if n.endswith("k_proj.bias"):
            continue       # zero up to rounding: softmax is shift invariant
        torch.testing.assert_close(res["flash"][1][n], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()))
    for n, p in res["dense"][2].items():
        torch.testing.assert_close(res["flash"][2][n], p, rtol=0, atol=1e-5)


# -- float16 lanes of B1-B3, and AMP on the card ------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,d", [
    (1, 1, 32), (15, 17, 64), (17, 15, 128), (63, 65, 32), (65, 63, 64),
    (64, 64, 128), (127, 129, 32), (129, 127, 64), (1, 1000, 64),
    (1000, 1, 128), (1000, 129, 128), (129, 1000, 32), (1000, 1000, 64)])
def test_flash_fp16_kernels_at_tile_edges(cuda, causal, sq, skv, d):
    """B1, B2 and B3 in float16 at the bf16 cases' tile edges: O within
    2e-2 of the plain version (LSE 1e-4), the gradients within 2e-2 (max
    |err| / max |plain|), all finite, in float16."""
    q, k, v, do, out, lse, delta = _bwd_case(cuda, torch.float16, 1, sq, skv,
                                             2, d, causal, seed=sq + skv + d)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert out.dtype == torch.float16
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    args = (q, k, v, do, lse, delta, causal)
    got = (tfa.flash_attention_bwd_dq(*args),
           *tfa.flash_attention_bwd_dkv(*args))
    plain = (tfa.flash_attention_bwd_dq_plain(*args),
             *tfa.flash_attention_bwd_dkv_plain(*args))
    assert all(g.dtype == torch.float16 and bool(torch.isfinite(g).all())
               for g in got)
    errs = _rel_errs([g.float() for g in got], [p.float() for p in plain])
    assert max(errs) <= 2e-2, errs


def test_flash_fp16_kernels_are_deterministic_and_take_f32_grads(cuda):
    """No atomics in float16 either: two launches agree bit for bit. f32
    gradients from float16 inputs (grad_dtypes) carry the residual of P
    and dS: within 1e-4 of the plain version."""
    q, k, v, do, out, lse, delta = _bwd_case(cuda, torch.float16, 2, 1000,
                                             1000, 4, 128, True)
    first = tfa.flash_attention_fwd(q, k, v, causal=True)
    again = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    args = (q, k, v, do, lse, delta, True)
    first = (tfa.flash_attention_bwd_dq(*args),
             *tfa.flash_attention_bwd_dkv(*args))
    again = (tfa.flash_attention_bwd_dq(*args),
             *tfa.flash_attention_bwd_dkv(*args))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    f32 = (torch.float32,) * 3
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, True,
                                  grad_dtypes=f32)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                         grad_dtypes=f32)
    errs = _rel_errs(got, want)
    assert all(g.dtype == torch.float32 for g in got)
    assert max(errs) <= 1e-4, errs


def test_flash_fp16_overflowing_ds_reaches_the_gradient(cuda):
    """dS rounded to float16 for the dQ and dK products overflows to inf
    and is never clamped, so the gradient is not finite and a loss scaler
    skips the step. All keys equal and two of them: P = 1/2 and the two
    dS of a row cancel in dQ = scale * dS K, so the plain version's dQ
    (f32 inside) is small and finite, and a clamped dS would cancel too.
    The same inputs in bfloat16 (whose range holds dS) give a finite dQ."""
    rng = np.random.default_rng(7)
    b, sq, skv, h, d = 1, 64, 2, 2, 64
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = np.repeat(rng.standard_normal((b, 1, h, d), dtype=np.float32), skv,
                  axis=1)
    v = rng.standard_normal((b, skv, h, d), dtype=np.float32)
    do = np.clip(3e4 * rng.standard_normal((b, sq, h, d)), -6e4, 6e4)
    res = {}
    for dt in (torch.float16, torch.bfloat16):
        qt, kt, vt, dot = (torch.from_numpy(np.asarray(x, np.float32)).to(
            cuda, dt) for x in (q, k, v, do))
        out, lse = tfa.flash_attention_fwd(qt, kt, vt)
        delta = tfa.attention_delta(out, dot)
        args = (qt, kt, vt, dot, lse, delta)
        res[dt] = (tfa.flash_attention_bwd_dq(*args),
                   tfa.flash_attention_bwd_dq_plain(*args),
                   tfa.flash_attention_bwd_dkv(*args)[0])
    dq, plain_dq, dk = res[torch.float16]
    assert bool(torch.isfinite(plain_dq).all())
    assert not bool(torch.isfinite(dq).all())
    assert not bool(torch.isfinite(dk).all())
    assert bool(torch.isfinite(res[torch.bfloat16][0]).all())


def _amp_train(cuda, impl, steps, ids):
    from paddle_tpu_torch import Model, amp
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    net = GPTForCausalLM(GPTConfig(**MODEL, attn_impl=impl), device=cuda,
                         seed=0)
    model = Model(net)
    model.prepare(AdamW(learning_rate=1e-3, parameters=net.parameters(),
                        epsilon=1e-6), GPTPretrainingCriterion())
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv)
    losses, launched = [], []
    for _ in range(steps):
        before = [c.launches_by_dtype.get("bfloat16", 0) for c in counters]
        with amp.auto_cast():
            losses.append(model.train_batch([ids], [ids])[0])
        launched.append([c.launches_by_dtype.get("bfloat16", 0) - n
                         for c, n in zip(counters, before)])
    return losses, launched, net


def test_amp_o1_train_step_runs_the_bf16_lanes(cuda):
    """Three O1 bfloat16 AdamW steps of a 2-layer GPT on the card: the
    flash model launches the bfloat16 lanes of B1, B2 and B3 once per
    layer a step, keeps float32 weights, and its losses agree with the
    dense-attention model's at 2e-2."""
    ids = np.random.default_rng(2).integers(0, MODEL["vocab_size"], (3, 64))
    flash, launched, net = _amp_train(cuda, "flash", 3, ids)
    dense, none, _ = _amp_train(cuda, "dense", 3, ids)
    assert launched == [[MODEL["num_layers"]] * 3] * 3
    assert none == [[0] * 3] * 3
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(np.isfinite(flash)) and flash[-1] < flash[0]
    np.testing.assert_allclose(flash, dense, rtol=0, atol=2e-2)


def test_resolve_device_turns_reduced_precision_reductions_off(cuda):
    """Resolving CUDA keeps cuBLAS from adding split-K partial sums of
    bfloat16 and float16 products in the low type (XLA sums them in
    float32), beside TF32 off."""
    from paddle_tpu_torch import resolve_device
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    matmul.allow_fp16_reduced_precision_reduction = True
    resolve_device()
    assert not matmul.allow_bf16_reduced_precision_reduction
    assert not matmul.allow_fp16_reduced_precision_reduction
    assert not matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


# -- greedy NMS (B5) and the detection path -----------------------------------

def _nms_case(seed, p_n, k, kind="boxes", side=608.0):
    """iou [P, k, k], valid [P, k] int32, thr [P] on the CPU: the IoU of
    random boxes at the YOLOv3 path's density (608 px image, box sides
    10 to 300 px), with ~15% invalid rows, or:

    - ``asymmetric``: a random asymmetric matrix;
    - ``nan``: 5% of the overlaps NaN;
    - ``nan_edges``: besides, every overlap NaN in the rows and columns
      on either side of each 32-candidate boundary;
    - ``disjoint``: boxes on a grid that never overlap, every row valid
      (every candidate is kept: the longest fold);
    - ``identical``: one box repeated, every row valid (one is kept);
    - ``eta_cross``: a threshold per problem in [0.55, 0.75], so that an
      eta of 0.995 takes it under 0.5 after 19 to 81 kept boxes, at a
      different candidate in each problem (and an eta of 0.9999 never
      does within 200 candidates)."""
    gen = torch.Generator().manual_seed(seed)
    thr = torch.full((p_n,), 0.45)
    if kind in ("disjoint", "identical"):
        side_n = int(np.ceil(np.sqrt(k)))
        cell = torch.arange(k, dtype=torch.float32)
        c = torch.stack([cell % side_n, cell // side_n], -1) * 20.0
        if kind == "identical":
            c = torch.zeros_like(c)
        boxes = torch.cat([c, c + 10.0], dim=-1).expand(p_n, k, 4)
        return (tdet._pairwise_iou(boxes, boxes).contiguous(),
                torch.ones(p_n, k, dtype=torch.int32), thr)
    if kind == "asymmetric":
        iou = torch.rand(p_n, k, k, generator=gen)
    else:
        c = torch.rand(p_n, k, 2, generator=gen) * side
        wh = 10 + torch.rand(p_n, k, 2, generator=gen) * 290
        boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
        iou = tdet._pairwise_iou(boxes, boxes)
        if kind in ("nan", "nan_edges"):
            iou[torch.rand(iou.shape, generator=gen) < 0.05] = float("nan")
        if kind == "nan_edges":
            edges = [e for b in range(32, k, 32) for e in (b - 1, b)]
            iou[:, edges, :] = float("nan")
            iou[:, :, edges] = float("nan")
    valid = (torch.rand(p_n, k, generator=gen) < 0.85).to(torch.int32)
    if kind == "eta_cross":
        thr = 0.55 + 0.2 * torch.rand(p_n, generator=gen)
    return iou, valid, thr


#: candidate counts at and around the kernel's tile edges (32, 64, 128)
NMS_EDGE_K = (31, 32, 33, 63, 64, 65, 127, 128, 129)


@pytest.mark.parametrize("p_n,k,kind,eta", [
    (64, 400, "boxes", 1.0), (64, 400, "boxes", 0.9), (8, 1, "boxes", 1.0),
    (8, 45, "boxes", 1.0), (8, 77, "asymmetric", 1.0),
    (8, 77, "asymmetric", 0.7), (8, 300, "nan", 1.0),
    (2, 12500, "asymmetric", 1.0)]
    + [(8, k, "boxes", eta) for k in NMS_EDGE_K for eta in (1.0, 0.9)]
    + [(8, 400, "disjoint", 1.0), (8, 400, "disjoint", 0.9),
       (8, 200, "identical", 1.0), (16, 300, "eta_cross", 0.995),
       (8, 200, "eta_cross", 0.9999),
       (8, 200, "nan_edges", 1.0), (8, 200, "nan_edges", 0.9)],
    ids=["p64_k400", "p64_k400_eta", "k1", "k45", "asym", "asym_eta",
         "nan", "k12500_smem_over_48k"]
    + [f"edge_k{k}_eta{eta}" for k in NMS_EDGE_K for eta in (1.0, 0.9)]
    + ["disjoint", "disjoint_eta", "identical", "eta_cross_in_tile",
       "eta_never_crosses",
       "nan_edges", "nan_edges_eta"])
def test_nms_kernel_matches_plain_bit_exactly(cuda, p_n, k, kind, eta):
    iou, valid, thr = _nms_case(k, p_n, k, kind)
    valid[0] = 0                                   # a problem with none
    ic, vc, tc = iou.to(cuda), valid.to(cuda), thr.to(cuda)
    before = tcustom.greedy_nms.launches
    got = tcustom.greedy_nms(ic, vc, tc, eta)
    torch.cuda.synchronize()
    assert tcustom.greedy_nms.launches == before + 1
    ref = tcustom.greedy_nms_plain(ic, vc, tc, eta)
    assert got.dtype == torch.int32 and got.shape == (p_n, k)
    assert torch.equal(got, ref)
    assert int(got[0].sum()) == 0
    if p_n > 1:
        assert torch.equal(got.cpu(), tcustom.greedy_nms_plain(
            iou, valid, thr, eta))
    if kind == "disjoint":
        assert torch.equal(got[1:], vc[1:])
    if kind == "identical":
        assert got[1:].sum(1).tolist() == [1] * (p_n - 1)


def test_nms_kernel_refuses_what_it_does_not_take(cuda):
    iou, valid, thr = _nms_case(0, 2, 8)
    ic, vc, tc = iou.to(cuda), valid.to(cuda), thr.to(cuda)
    with pytest.raises(TypeError):
        tcustom.greedy_nms(ic.double(), vc, tc)
    with pytest.raises(TypeError):
        tcustom.greedy_nms(ic, vc.long(), tc)
    with pytest.raises(ValueError, match="contiguous"):
        tcustom.greedy_nms(ic.transpose(1, 2), vc, tc)
    with pytest.raises(ValueError, match="share a device"):
        tcustom.greedy_nms(ic, valid, tc)
    big = tcustom.MAX_NMS_K + 1
    with pytest.raises(ValueError, match="exceeds"):
        tcustom.greedy_nms(torch.empty(1, big, big, device=cuda),
                           torch.empty(1, big, dtype=torch.int32,
                                       device=cuda),
                           torch.empty(1, device=cuda))


def test_multiclass_nms_on_the_card_matches_the_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    n, c_n, m = 2, 5, 300
    ctr = torch.rand(n, m, 2, generator=gen) * 200
    wh = 4 + torch.rand(n, m, 2, generator=gen) * 60
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    scores = torch.rand(n, c_n, m, generator=gen)
    scores[torch.rand(scores.shape, generator=gen) < 0.3] = 0.0
    kw = dict(score_threshold=0.05, nms_top_k=100, keep_top_k=60,
              nms_threshold=0.45, background_label=-1)
    ref_d, ref_c = tdet.multiclass_nms(boxes, scores, **kw)
    before = tcustom.greedy_nms.launches
    got_d, got_c = tdet.multiclass_nms(boxes.to(cuda), scores.to(cuda), **kw)
    assert tcustom.greedy_nms.launches == before + 1
    assert got_c.dtype == torch.int32
    assert torch.equal(got_c.cpu(), ref_c)
    assert torch.equal(got_d[..., 0].cpu(), ref_d[..., 0])
    torch.testing.assert_close(got_d.cpu(), ref_d, rtol=1e-5, atol=1e-4)


def test_yolov3_served_on_the_card_launches_nms(cuda):
    """The tiny detector through the Engine on the card: every request
    resolves, rows as submitted, one NMS launch per batch."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, ExecutableCache
    from paddle_tpu_torch.vision.models import YOLOv3
    model = YOLOv3(num_classes=4, width_mult=0.125, device=cuda).eval()

    def serve(img, hw):
        with torch.inference_mode():
            return model.decode(model(img), hw)

    rng = np.random.default_rng(0)
    reqs = [[rng.random((r, 3, 64, 64), dtype=np.float32),
             np.full((r, 2), 64, np.int32)] for r in (1, 2, 1, 3)]
    eng = Engine(serve, EngineConfig(batch_buckets=(1, 2, 4), max_batch=4,
                                     max_batch_delay=0.2),
                 cache=ExecutableCache())
    before = tcustom.greedy_nms.launches
    outs = [f.result(120) for f in eng.submit_many(reqs)]
    batches = eng.stats()["stats"]["serving.batches"]
    eng.drain(60)
    assert tcustom.greedy_nms.launches - before == batches
    for (img, _), (dets, counts) in zip(reqs, outs):
        assert dets.shape == (img.shape[0], 100, 6)
        assert counts.dtype == np.int32 and (counts <= 100).all()
        assert np.isfinite(dets).all()


# -- compiled decode: CUDA graphs against the eager lane -----------------------

def _serve_lanes(model, prompts, new=8, one_at_a_time=False, **cfg):
    """``{lane: (token lists, engine)}`` of one engine config, graphed
    (the default) and on the eager lane (``disable_graphs``). With
    ``one_at_a_time`` each request waits for the one before, so both
    lanes tick the same slots in the same order (sampling draws for every
    slot every tick)."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving import ExecutableCache
    out = {}
    for lane in ("graphed", "eager"):
        ctx = (graphs.disable_graphs() if lane == "eager"
               else contextlib.nullcontext())
        with ctx:
            eng = LLMEngine(model, LLMEngineConfig(
                num_slots=4, max_seq=64, prefill_buckets=(8, 16), **cfg),
                cache=ExecutableCache())
            try:
                if one_at_a_time:
                    toks = [eng.submit(p, max_new_tokens=new,
                                       **samp).result(timeout=120)["tokens"]
                            for p, samp in prompts]
                else:
                    reqs = [eng.submit(p, max_new_tokens=new, **samp)
                            for p, samp in prompts]
                    toks = [r.result(timeout=120)["tokens"] for r in reqs]
            finally:
                eng.drain(timeout=60)
        out[lane] = (toks, eng)
    return out


def _steps(eng):
    stats = eng.stats()["stats"]
    return (stats["serving.llm.decode_ticks"]
            + stats["serving.llm.warmup_decode_steps"])


@pytest.mark.parametrize("lane", [{}, {"kv_layout": "paged", "page_size": 4,
                                       "paged_attn_impl": "kernel"},
                                  {"kv_layout": "paged", "page_size": 4,
                                   "paged_attn_impl": "gather"}],
                         ids=["slot", "paged_kernel", "paged_gather"])
def test_graphed_engine_gives_the_eager_lanes_tokens(cuda, lane):
    """The engine's decode step and prefills replay CUDA graphs captured
    at warm-up (one decode capture, one per bucket, none after) and give
    the eager lane's greedy tokens exactly; on the kernel lane B4's count
    takes the replays: one launch a layer a step in both lanes."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, MODEL["vocab_size"], n).tolist(), {})
               for n in (5, 7, 10, 13)]
    before = tpa.paged_attention.launches
    lanes = _serve_lanes(model, prompts, **lane)
    (graphed, eng), (eager, eager_eng) = lanes["graphed"], lanes["eager"]
    assert graphed == eager
    assert all(len(t) == 8 for t in graphed)
    fn = eng.decoder.decode_fn(4, 64)
    assert fn.trace_counter["traces"] == 1
    assert fn.replays == eng.stats()["stats"]["serving.llm.decode_ticks"]
    assert [eng.decoder.prefill_fn(1, b).trace_counter["traces"]
            for b in (8, 16)] == [1, 1]
    assert eng.stats()["graph_pool_bytes"] > 0
    assert eager_eng.decoder.decode_fn(4, 64).trace_counter["traces"] == 0
    launched = tpa.paged_attention.launches - before
    if lane.get("paged_attn_impl") == "kernel":
        assert launched == MODEL["num_layers"] * (_steps(eng)
                                                  + _steps(eager_eng))
    else:
        assert launched == 0


def test_graphed_sampled_engine_streams_equal_the_eager_lanes(cuda):
    """Sampled requests: the graph registers the engine's generator, so
    each replay draws at the generator's advancing offset, as the eager
    lane does: the streams are equal at one seed."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    samp = dict(do_sample=True, temperature=0.9, top_k=20)
    prompts = [([3, 1, 4, 1, 5], samp), ([9, 2, 6], samp), ([5, 5], {}),
               ([8] * 12, dict(samp, top_k=0))]
    lanes = _serve_lanes(model, prompts, new=12, one_at_a_time=True, seed=7)
    assert lanes["graphed"][0] == lanes["eager"][0]
    # the draws move from replay to replay: a sampled stream is not flat
    assert len(set(lanes["graphed"][0][0])) > 1


@pytest.mark.parametrize("strategy", ["greedy", "sampling"])
def test_graphed_generate_gives_the_eager_lanes_tokens(cuda, strategy):
    """``generate``'s static lane replays its programs: the eager lane's
    tokens (sampling from one seed), and a second call captures nothing."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    ids = np.random.default_rng(2).integers(0, MODEL["vocab_size"], (2, 9))
    kw = dict(max_length=12, decode_strategy=strategy, top_k=8)
    seed(3)
    first = model.generate(ids, **kw).cpu().numpy()
    dec = GPTStaticDecoder(model, max_top_k=8 if strategy == "sampling"
                           else 0)
    fns = (dec.decode_fn(2, 32), dec.prefill_fn(2, 16))
    traces = [f.trace_counter["traces"] for f in fns]
    replays = fns[0].replays
    seed(3)
    second = model.generate(ids, **kw).cpu().numpy()
    assert [f.trace_counter["traces"] for f in fns] == traces
    assert fns[0].replays == replays + 11
    seed(3)
    with graphs.disable_graphs():
        eager = model.generate(ids, **kw).cpu().numpy()
    np.testing.assert_array_equal(first, eager)
    np.testing.assert_array_equal(second, eager)
    if strategy == "greedy":
        ref = _cpu_twin(model).generate(ids, max_length=12).numpy()
        np.testing.assert_array_equal(first, ref)


def _graphed_logits(dec, kv, params, last, attn_impl=None):
    """One decode step's logits through a captured graph (its first call,
    the warm-up, and a replay) on the cache's current state."""
    import functools
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving.llm.decode import static_decode_logits
    from paddle_tpu_torch.serving.llm.paged import paged_decode_logits
    if attn_impl is None:
        raw = functools.partial(static_decode_logits, dec.spec)
    else:
        raw = functools.partial(paged_decode_logits, dec.spec,
                                attn_impl=attn_impl)
        kv.refresh_block_tables()
    prog = graphs.Program(raw)
    with torch.no_grad():
        first = prog(params, kv, last).clone()
        replayed = prog(params, kv, last).clone()
    assert prog.trace_counter["traces"] == 1 and prog.replays == 1
    return first, replayed


@pytest.mark.parametrize("lane", ["slot", "kernel", "gather"])
def test_graphed_decode_logits_are_bitwise_the_eager_lanes(cuda, lane):
    """The same kernels on the same inputs: a replayed decode step's
    logits equal the eager step's bit for bit."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    dec = (GPTStaticDecoder(model) if lane == "slot"
           else GPTPagedDecoder(model, page_size=4, attn_impl=lane))
    kv, params = dec.new_kv(4, 64), dec.params()
    fin = torch.zeros(4, dtype=torch.bool, device=cuda)
    samp = pack_sampling([SamplingParams()], cuda)
    last = torch.zeros(4, dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(5)
    for slot, n in enumerate((3, 17, 30, 9)):
        kv.alloc()
        if lane != "slot":
            kv.ensure_pages(slot, n + 1)
        lp = 1 << (n - 1).bit_length()
        toks = torch.zeros(1, lp, dtype=torch.int32, device=cuda)
        toks[0, :n] = torch.from_numpy(rng.integers(0, 256, n))
        nxt, fin = dec.prefill(
            kv, params, toks, torch.tensor([n], dtype=torch.int32,
                                           device=cuda),
            torch.tensor([slot], dtype=torch.int32, device=cuda), fin,
            samp, None)
        last[slot] = nxt[0]
    eager = (dec.decode_logits(kv, params, last) if lane == "slot"
             else dec.decode_logits(kv, params, last, lane))
    first, replayed = _graphed_logits(dec, kv, params, last,
                                      None if lane == "slot" else lane)
    assert torch.equal(first, eager)
    assert torch.equal(replayed, eager)


class _State:
    """A program's state for a lone kernel: only the graph pool."""

    def __init__(self, device):
        from paddle_tpu_torch.core import graphs
        self.graph_pool = graphs.GraphPool(device)


def test_captured_paged_kernel_replays_match_plain(cuda):
    """B4 captured once and replayed 20 times on new queries and
    positions (copied into the graph's inputs): every replay within 1e-4
    of the plain version, so the ticket array is back at zero after each,
    and each replay counts one launch."""
    from paddle_tpu_torch.core import graphs
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(11, pps=8))
    kb, vb = ak[:, 1], av[:, 1]
    prog = graphs.Program(lambda params, state, q, positions:
                          tpa.paged_attention(q, kb, vb, bt, positions))
    state = _State(cuda)
    before = tpa.paged_attention.launches
    prog(None, state, q.clone(), pos.clone())
    assert tpa.paged_attention.launches == before + 1   # the warm-up
    rng = np.random.default_rng(12)
    limit = bt.shape[1] * ak.shape[2] + 3
    for _ in range(20):
        qi = torch.from_numpy(rng.standard_normal(
            tuple(q.shape), dtype=np.float32)).to(cuda)
        pi = torch.from_numpy(rng.integers(
            0, limit, pos.shape[0]).astype(np.int32)).to(cuda)
        out = prog(None, state, qi, pi)
        ref = tpa.paged_attention_plain(qi, kb, vb, bt, pi)
        assert (out - ref).abs().max().item() <= 1e-4
    assert prog.replays == 20 and prog.trace_counter["traces"] == 1
    assert tpa.paged_attention.launches == before + 21


def test_two_same_shape_engines_on_the_card_give_their_own_tokens(cuda):
    """Two models of one config, two engines serving at once in one
    process (one program per signature in the shared default cache, one
    graph per KV cache): each gives its own model's CPU tokens."""
    models = [GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=s).eval()
              for s in (0, 5)]
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 20))]
    engines = [LLMEngine(m, LLMEngineConfig(num_slots=4, max_seq=64,
                                            prefill_buckets=(8, 32)))
               for m in models]
    try:
        fn = engines[0].decoder.decode_fn(4, 64)
        assert fn is engines[1].decoder.decode_fn(4, 64)
        reqs = [[e.submit(p, max_new_tokens=8) for p in prompts]
                for e in engines]
        got = [[r.result(timeout=120)["tokens"] for r in rs] for rs in reqs]
    finally:
        for e in engines:
            e.drain(timeout=60)
    for m, toks in zip(models, got):
        twin = _cpu_twin(m)
        for p, t in zip(prompts, toks):
            ref = twin.generate(np.array([p]), max_length=8).numpy()[0]
            assert t == ref[len(p):].tolist()
    assert got[0] != got[1]


# -- the compiled train step (core/graphs.py, hapi/model.py) ------------------

def _flash_counts():
    return [c.launches for c in (tfa.flash_attention_fwd,
                                 tfa.flash_attention_bwd_dq,
                                 tfa.flash_attention_bwd_dkv)]


def _train_model(cuda, precision="fp32", clip="global", dropout=0.0,
                 lr=1e-3):
    """A 2-layer flash GPT from seed 0 in a Model with AdamW (eps 1e-6,
    so k_proj.bias's zero-up-to-rounding gradient stays small); O2 casts
    the model to bfloat16 and keeps float32 masters."""
    from paddle_tpu_torch import Model, amp, nn
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dict(MODEL, hidden_dropout_prob=dropout)
    net = GPTForCausalLM(GPTConfig(**cfg, attn_impl="flash"), device=cuda,
                         seed=0)
    if precision == "o2":
        amp.decorate(net, level="O2")
    clips = {"global": nn.ClipGradByGlobalNorm(1.0),
             "norm": nn.ClipGradByNorm(0.5), "value": nn.ClipGradByValue(0.01)}
    model = Model(net)
    model.prepare(AdamW(learning_rate=lr, parameters=net.parameters(),
                        epsilon=1e-6, grad_clip=clips[clip],
                        multi_precision=precision == "o2"),
                  GPTPretrainingCriterion())
    return model, net


def _cast(precision):
    from paddle_tpu_torch import amp
    if precision == "fp32":
        return contextlib.nullcontext()
    return amp.auto_cast(level="O2" if precision == "o2" else "O1")


def _equal_or_close(got, ref, what):
    """Bitwise, or within 1e-5 relative; names the first step that is
    neither."""
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b or abs(a - b) <= 1e-5 * abs(b), \
            f"{what}: step {i + 1} differs: {a} vs {b}"


TRAIN_IDS = np.random.default_rng(3).integers(0, MODEL["vocab_size"],
                                              (5, 2, 64))


@pytest.mark.parametrize("precision,clip", [
    ("fp32", "global"), ("o1", "global"), ("o2", "global"),
    ("fp32", "norm"), ("fp32", "value")])
def test_graphed_train_batch_equals_the_eager_lane(cuda, precision, clip):
    """Five train_batch steps captured once and replayed against the same
    five steps on the eager lane (disable_graphs), fresh weights from one
    seed: equal losses and weights, one trace, four replays, and B1-B3
    counted once per layer a step through the replays."""
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager"):
        model, net = _train_model(cuda, precision, clip)
        before = _flash_counts()
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cast(precision):
            losses = [model.train_batch([b], [b])[0] for b in TRAIN_IDS]
        launched = [a - b for a, b in zip(_flash_counts(), before)]
        assert launched == [len(TRAIN_IDS) * MODEL["num_layers"]] * 3, \
            (lane, launched)
        res[lane] = (losses, {n: p.detach().clone()
                              for n, p in net.named_parameters()}, model)
    prog = res["graphed"][2]._train_step_fn["fn"]
    assert prog.trace_counter["traces"] == 1 and prog.replays == 4
    assert res["eager"][2]._train_step_fn["fn"].trace_counter["traces"] == 0
    _equal_or_close(res["graphed"][0], res["eager"][0], "losses")
    assert all(np.isfinite(res["graphed"][0]))
    for n, p in res["eager"][1].items():
        torch.testing.assert_close(res["graphed"][1][n], p, rtol=1e-5,
                                   atol=1e-5, msg=n)


def test_graphed_train_step_draws_fresh_dropout_masks(cuda):
    """With hidden dropout 0.1 (and lr 0, so the weights stay), each
    replay draws new masks from the model's generator, registered with
    the graph: two replays give two losses, and re-seeding repeats
    them."""
    import paddle_tpu_torch as P
    model, _ = _train_model(cuda, dropout=0.1, lr=0.0)
    b = TRAIN_IDS[0]
    model.train_batch([b], [b])                 # warm-up and capture
    P.seed(5)
    first = [model.train_batch([b], [b])[0] for _ in range(2)]
    P.seed(5)
    again = [model.train_batch([b], [b])[0] for _ in range(2)]
    assert model._train_step_fn["fn"].replays == 4
    assert first[0] != first[1] and first == again


def test_graphed_train_step_refuses_a_moved_parameter(cuda):
    model, net = _train_model(cuda)
    b = TRAIN_IDS[0]
    model.train_batch([b], [b])
    model.train_batch([b], [b])
    w = net.gpt.word_embeddings.weight
    w.data = w.data.clone()
    with pytest.raises(RuntimeError, match="not where"):
        model.train_batch([b], [b])


@pytest.mark.parametrize("precision", ["fp32", "o1"])
def test_train_loop_equals_graphed_train_batch(cuda, precision):
    """train_loop over 5 steps (flat buffers, one captured program)
    against 5 graphed train_batch calls on fresh weights from one seed,
    and train_batches against both."""
    res = {}
    for how in ("train_batch", "train_loop", "train_batches"):
        model, net = _train_model(cuda, precision)
        before = _flash_counts()
        with _cast(precision):
            if how == "train_batch":
                losses = [model.train_batch([b], [b])[0] for b in TRAIN_IDS]
            else:
                losses = getattr(model, how)([TRAIN_IDS], [TRAIN_IDS])
        launched = [a - b for a, b in zip(_flash_counts(), before)]
        assert launched == [len(TRAIN_IDS) * MODEL["num_layers"]] * 3, \
            (how, launched)
        if how == "train_loop":
            assert model._fused_loop is not None
            assert model._fused_loop["fn"].replays == len(TRAIN_IDS) - 1
        res[how] = (losses, {n: p.detach().clone()
                             for n, p in net.named_parameters()})
    for how in ("train_loop", "train_batches"):
        _equal_or_close(res[how][0], res["train_batch"][0], how)
        for n, p in res["train_batch"][1].items():
            torch.testing.assert_close(res[how][1][n], p, rtol=1e-5,
                                       atol=1e-5, msg=f"{how} {n}")


@pytest.mark.parametrize("method", ["train_batches", "train_loop"])
def test_multi_step_does_not_sync_between_steps(cuda, method):
    """Once captured, K steps of train_batches or train_loop make one
    synchronizing call, the losses' read at the end."""
    import warnings
    model, _ = _train_model(cuda)
    ids = torch.from_numpy(TRAIN_IDS).to(cuda)
    getattr(model, method)([ids[:2]], [ids[:2]])   # warm-up and capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = getattr(model, method)([ids], [ids])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(losses) == len(TRAIN_IDS)
    assert len(syncs) == 1, [str(w.message) for w in syncs]


# -- ResNet and BERT training on the card -------------------------------------

def _vision_model(cuda, net, lr=0.01):
    from paddle_tpu_torch import Model, nn
    from paddle_tpu_torch.optimizer import Momentum
    model = Model(net)
    model.prepare(Momentum(learning_rate=lr, momentum=0.9,
                           parameters=net.parameters(), weight_decay=1e-4),
                  nn.CrossEntropyLoss())
    return model


class _ConvBN(torch.nn.Module):
    """conv, train-mode BN, ReLU, max pool, adaptive pool, flatten, linear."""

    def __init__(self, cuda):
        super().__init__()
        from paddle_tpu_torch import nn
        self.conv = nn.Conv2D(3, 8, 3, padding=1, bias_attr=False,
                              device=cuda)
        self.bn = nn.BatchNorm2D(8, device=cuda)
        self.pool = nn.MaxPool2D(3, 2, 1)
        self.avg = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(8, 10, device=cuda)
        nn.layers_common.reset_parameters(self, torch.Generator(
            device=cuda).manual_seed(0))

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F
        x = self.pool(F.relu(self.bn(self.conv(x))))
        return self.fc(torch.flatten(self.avg(x), 1))


# 16 images of 64x64: BN's last stages see 4 values a channel per image,
# enough that rounding does not swamp a 5-step comparison
VISION_X = np.random.default_rng(5).random((5, 16, 3, 64, 64),
                                           dtype=np.float32)
VISION_Y = np.random.default_rng(6).integers(0, 10, (5, 16))


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN held to its deterministic algorithms: its default
    weight-gradient algorithms may sum with atomics, so two runs of one
    step part by rounding, which training amplifies."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _vision_lanes(cuda, build, precision, lr=0.001):
    """Five train_batch steps graphed and on the eager lane, fresh weights
    each, cuDNN deterministic: (losses, state dict) per lane."""
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager"):
        net = build()
        model = _vision_model(cuda, net, lr)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cast(precision), _cudnn_deterministic():
            losses = [model.train_batch([x], [y])[0]
                      for x, y in zip(VISION_X, VISION_Y)]
        res[lane] = (losses, {k: v.detach().clone()
                              for k, v in net.state_dict().items()}, model)
    prog = res["graphed"][2]._train_step_fn["fn"]
    assert prog.trace_counter["traces"] == 1 and prog.replays == 4
    return res


def test_graphed_batch_norm_step_equals_the_eager_lane_bitwise(cuda):
    """Train-mode BN's running statistics are buffers updated in place
    inside the captured step: five replays leave the losses, weights and
    statistics bitwise those of five eager steps (cuDNN deterministic in
    both lanes)."""
    res = _vision_lanes(cuda, lambda: _ConvBN(cuda), "fp32", lr=0.01)
    assert res["graphed"][0] == res["eager"][0]
    for k, v in res["eager"][1].items():
        assert torch.equal(res["graphed"][1][k], v), k
    assert not torch.equal(res["eager"][1]["bn._mean"],
                           torch.zeros_like(res["eager"][1]["bn._mean"]))


@pytest.mark.parametrize("precision", ["fp32", "o1"])
def test_graphed_resnet_train_batch_equals_the_eager_lane(cuda, precision):
    """ResNet-18 (10 classes) on 16 images of 64x64, Momentum with the
    coupled decay, cuDNN deterministic: graphed against eager, losses,
    weights and BN statistics bitwise."""
    from paddle_tpu_torch.vision.models import resnet18
    res = _vision_lanes(cuda, lambda: resnet18(num_classes=10, device=cuda,
                                               seed=0), precision)
    assert res["graphed"][0] == res["eager"][0]
    assert all(np.isfinite(res["graphed"][0]))
    for k, v in res["eager"][1].items():
        assert torch.equal(res["graphed"][1][k], v), k


def test_resnet_train_loop_equals_graphed_train_batch(cuda):
    """Momentum's elementwise update on flat buffers: train_loop over five
    stacked batches against five graphed train_batch calls, cuDNN
    deterministic."""
    from paddle_tpu_torch.vision.models import resnet18
    got = {}
    for how in ("train_batch", "train_loop"):
        net = resnet18(num_classes=10, device=cuda, seed=0)
        model = _vision_model(cuda, net, 0.001)
        with _cudnn_deterministic():
            if how == "train_batch":
                losses = [model.train_batch([x], [y])[0]
                          for x, y in zip(VISION_X, VISION_Y)]
            else:
                losses = model.train_loop([VISION_X], [VISION_Y])
                assert model._fused_loop is not None
        got[how] = (losses, {k: v.detach().clone()
                             for k, v in net.state_dict().items()})
    _equal_or_close(got["train_loop"][0], got["train_batch"][0], "losses")
    for k, v in got["train_batch"][1].items():
        torch.testing.assert_close(got["train_loop"][1][k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)


BERT_SMALL = dict(vocab_size=1000, hidden_size=128, num_layers=2,
                  num_heads=2, intermediate_size=256,
                  max_position_embeddings=64)


class _MLMHead(torch.nn.Module):
    """bench.py's MLM head: BERT and a vocabulary linear."""

    def __init__(self, cuda, dropout):
        super().__init__()
        from paddle_tpu_torch import nn
        from paddle_tpu_torch.models import BertConfig, BertModel
        cfg = BertConfig(**BERT_SMALL, hidden_dropout_prob=dropout,
                         attention_dropout_prob=dropout)
        self.bert = BertModel(cfg, device=cuda, seed=0)
        self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size, device=cuda)
        nn.layers_common.reset_parameters(self.head, torch.Generator(
            device=cuda).manual_seed(1))

    def forward(self, ids):
        return self.head(self.bert(ids)[0])


def _bert_model(cuda, dropout=0.0):
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    net = _MLMHead(cuda, dropout)
    model = Model(net)
    model.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters(),
                        weight_decay=0.01, epsilon=1e-6),
                  lambda logits, labels: F.cross_entropy(
                      logits.reshape(-1, logits.shape[-1]),
                      labels.reshape(-1)))
    return model, net


BERT_IDS = np.random.default_rng(7).integers(0, BERT_SMALL["vocab_size"],
                                             (5, 4, 64))


@pytest.mark.parametrize("precision", ["fp32", "o1"])
def test_graphed_bert_train_batch_equals_the_eager_lane(cuda, precision):
    """The MLM head with dropout 0: attention takes B1-B3 (head dim 64,
    non-causal, once a layer a step, counted through the replays);
    graphed against eager, losses bitwise or 1e-5, weights within 1e-5,
    the unused pooler only decayed."""
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager"):
        model, net = _bert_model(cuda)
        pooler0 = net.bert.pooler.dense.weight.detach().clone()
        before = _flash_counts()
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cast(precision):
            losses = [model.train_batch([b], [b.astype(np.int64)])[0]
                      for b in BERT_IDS]
        launched = [a - b for a, b in zip(_flash_counts(), before)]
        assert launched == [len(BERT_IDS) * BERT_SMALL["num_layers"]] * 3, \
            (lane, launched)
        torch.testing.assert_close(net.bert.pooler.dense.weight,
                                   pooler0 * (1 - 1e-4 * 0.01) ** 5)
        res[lane] = (losses, {k: v.detach().clone()
                              for k, v in net.state_dict().items()}, model)
    prog = res["graphed"][2]._train_step_fn["fn"]
    assert prog.trace_counter["traces"] == 1 and prog.replays == 4
    _equal_or_close(res["graphed"][0], res["eager"][0], "losses")
    for k, v in res["eager"][1].items():
        torch.testing.assert_close(res["graphed"][1][k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)


def test_graphed_bert_with_dropout_trains_on_the_dense_lane(cuda):
    """bench.py's dropout 0.1: attention is dense (no flash launch, as in
    the JAX package), each replay draws fresh masks, the losses finite."""
    model, _ = _bert_model(cuda, dropout=0.1)
    before = _flash_counts()
    losses = [model.train_batch([b], [b.astype(np.int64)])[0]
              for b in BERT_IDS]
    assert _flash_counts() == before
    assert all(np.isfinite(losses))
    assert model._train_step_fn["fn"].replays == len(BERT_IDS) - 1


# -- B1-B3 at S = 4096, YOLOv3 training, recompute ----------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernels_at_s4096_match_plain(cuda, dtype, tol):
    """B1, B2 and B3 at the long-context GPT's length (S = 4096, D = 64,
    causal), two heads: each against its plain version."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(11, 1, 4096, 4096, 2, 64))
    do = torch.from_numpy(_qkv(12, 1, 4096, 4096, 2, 64)[0]).to(cuda, dtype)
    before = _flash_counts()
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    delta = tfa.attention_delta(out, do)
    args = (q, k, v, do, lse, delta, True)
    got = (tfa.flash_attention_bwd_dq(*args),
           *tfa.flash_attention_bwd_dkv(*args))
    want = (tfa.flash_attention_bwd_dq_plain(*args),
            *tfa.flash_attention_bwd_dkv_plain(*args))
    assert [a - b for a, b in zip(_flash_counts(), before)] == [1, 1, 1]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _max_rel(a, b) <= tol, name


def _yolo_case(seed, n=4, h=13, classes=80, slots=50):
    """A head of one scale and bench.py-style gt boxes (1-7 an image),
    with two boxes copied onto the cell of a third in every image."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3 * (5 + classes), h, h),
                            dtype=np.float32)
    gt_box = np.zeros((n, slots, 4), np.float32)
    gt_label = np.zeros((n, slots), np.int64)
    for i in range(n):
        m = int(rng.integers(1, 8))
        gt_box[i, :m, :2] = rng.uniform(0.2, 0.8, (m, 2))
        gt_box[i, :m, 2:] = rng.uniform(0.05, 0.4, (m, 2))
        gt_label[i, :m] = rng.integers(0, classes, m)
        gt_box[i, m:m + 2] = gt_box[i, 0]
        gt_label[i, m:m + 2] = (gt_label[i, 0] + 1) % classes
    return x, gt_box, gt_label


def test_yolov3_loss_on_the_card_matches_the_cpu(cuda):
    """yolov3_loss at bench.py's coarsest scale (13x13 at 416, 80
    classes, 50 gt slots): loss and input gradient on the card against
    the same call on the CPU at 1e-5 (of the largest), gt boxes sharing
    cells included; the gradient repeats bitwise."""
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
               116, 90, 156, 198, 373, 326]
    x, gt_box, gt_label = _yolo_case(21)
    out = {}
    for dev in ("cpu", cuda, cuda):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        loss = tdet.yolov3_loss(xt, torch.from_numpy(gt_box).to(dev),
                                torch.from_numpy(gt_label).to(dev), anchors,
                                [6, 7, 8], 80, 0.7, 32)
        loss.sum().backward()
        out.setdefault(str(dev), []).append(
            (loss.detach().cpu(), xt.grad.cpu()))
    (lc, gc), = out["cpu"]
    (l1, g1), (l2, g2) = out[str(cuda)]
    torch.testing.assert_close(l1, lc, rtol=1e-5, atol=0)
    assert (g1 - gc).abs().max() <= 1e-5 * gc.abs().max()
    assert torch.equal(g1, g2) and torch.equal(l1, l2)


def _tiny_yolo_model(cuda):
    """bench.py's YOLOv3 recipe at the tiny size: Momentum(1e-3, 0.9,
    weight decay 5e-4) and YOLOv3Loss."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import YOLOv3, YOLOv3Loss
    net = YOLOv3(num_classes=80, width_mult=0.125, device=cuda, seed=0)
    model = Model(net)
    model.prepare(Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=net.parameters(), weight_decay=5e-4),
                  YOLOv3Loss(net))
    return model, net


YOLO_X = np.random.default_rng(13).random((5, 4, 3, 128, 128),
                                          dtype=np.float32)
YOLO_GT = [_yolo_case(30 + i, n=4)[1:] for i in range(5)]


@pytest.mark.parametrize("precision", ["fp32", "o1"])
def test_graphed_yolov3_train_batch_equals_the_eager_lane(cuda, precision):
    """Five YOLOv3 train steps (three head outputs, a box and a label
    tensor, train-mode BN updated inside the graph) captured once and
    replayed, against the eager lane on fresh weights, cuDNN
    deterministic: losses, weights and BN statistics bitwise (or within
    1e-5); no port kernel launches."""
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager"):
        model, net = _tiny_yolo_model(cuda)
        before = _flash_counts() + [tcustom.greedy_nms.launches]
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cast(precision), _cudnn_deterministic():
            losses = [model.train_batch([x], list(gt))[0]
                      for x, gt in zip(YOLO_X, YOLO_GT)]
        assert _flash_counts() + [tcustom.greedy_nms.launches] == before
        res[lane] = (losses, {k: v.detach().clone()
                              for k, v in net.state_dict().items()}, model)
    prog = res["graphed"][2]._train_step_fn["fn"]
    assert prog.trace_counter["traces"] == 1 and prog.replays == 4
    assert all(np.isfinite(res["graphed"][0]))
    _equal_or_close(res["graphed"][0], res["eager"][0], "losses")
    for k, v in res["eager"][1].items():
        torch.testing.assert_close(res["graphed"][1][k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)


def _recompute_blocks(net):
    """bench.py:296-301: every decoder block's forward through
    ``fleet.utils.recompute``."""
    from paddle_tpu_torch.distributed.fleet import utils
    for layer in net.gpt.decoder.layers:
        orig = layer.forward
        layer.forward = (lambda *a, __f=orig, **k:
                         utils.recompute(__f, *a, **k))


def test_graphed_recompute_step_with_dropout_equals_eager_and_plain(cuda):
    """Hidden dropout 0.1, every block recomputed: five graphed steps
    (the recomputed forward inside the captured backward reuses the
    forward's masks) equal five eager ones and five graphed steps
    without recompute, losses and weights; B1 launches twice a layer a
    step, B2 and B3 once."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager", "plain"):
        P.seed(9)
        model, net = _train_model(cuda, dropout=0.1)
        if lane != "plain":
            _recompute_blocks(net)
        before = _flash_counts()
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx:
            losses = [model.train_batch([b], [b])[0] for b in TRAIN_IDS]
        launched = [a - b for a, b in zip(_flash_counts(), before)]
        per = len(TRAIN_IDS) * MODEL["num_layers"]
        assert launched == [per * (1 if lane == "plain" else 2), per, per], \
            (lane, launched)
        res[lane] = (losses, {n: p.detach().clone()
                              for n, p in net.named_parameters()})
    assert len(set(res["plain"][0])) == len(TRAIN_IDS)
    for lane in ("eager", "plain"):
        _equal_or_close(res["graphed"][0], res[lane][0], lane)
        for n, p in res[lane][1].items():
            torch.testing.assert_close(res["graphed"][1][n], p, rtol=1e-5,
                                       atol=1e-5, msg=f"{lane} {n}")
