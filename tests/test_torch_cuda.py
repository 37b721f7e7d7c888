"""The port's CUDA kernels on the card: each kernel against its plain
version (B1-B3 in float32, bfloat16 and float16), the wrappers' refusals
(no fallback on a CUDA tensor), the GPT forward, an O1 bfloat16 train step
and the paged engine through the kernels at a small size, ``generate`` in
its three cache modes and the default static-slot engine against the CPU,
the YOLOv3 detection path (greedy NMS on the card against the CPU), and
the engine's prefix reuse and speculative decode, graphed against eager,
with B4 over shared pages, and the `Model` loop: each optimizer rule's
graphed step, the compiled eval program, EMA/ModelAverage/LookAhead in
place, and a `DataLoader` through the shared-memory ring; the host-plane
substrate: metered train steps and engines unchanged, the kernels' FLOP
formulas counted, a drain by signal and a capture under the profiler;
training that survives faults: the guarded graphed step against the
guarded eager one, an async snapshot against the steps queued behind it,
a rollback into a live captured program, the probe's one sync.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on a machine with a card but
without jax it runs on its own, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import contextlib
import importlib
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops import custom as tcustom
from paddle_tpu_torch.ops import detection as tdet
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
from paddle_tpu_torch.serving.llm.paged import GPTPagedDecoder
from test_torch_op_table import (CUDA_CASES, HOST_CASES, LAYER_CASES,
                                 NER_TAGS, bert_crf_tagger, cond_net,
                                 cuda_case_holds, gpt_beam_cells,
                                 iob_tags, layer_case_holds,
                                 random_ops_hold, structured_draws_hold)

from test_torch_a9_table import (DET_CASES, FRCNN, RNN_CASES,  # noqa: E402
                                 detect, frcnn_inputs, lstm_lm, roi_features,
                                 rpn_to_rois)

tfa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

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

def _serve_lanes(model, prompts, new=8, one_at_a_time=False, draft=None,
                 **cfg):
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
                cache=ExecutableCache(), draft_model=draft)
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


_LAYOUTS = {"slot": {}, "paged": {"kv_layout": "paged", "page_size": 4,
                                  "paged_attn_impl": "kernel"}}


@pytest.mark.parametrize("draft", ["self", "small"])
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_graphed_spec_engine_gives_the_eager_lanes_tokens(cuda, layout,
                                                          draft):
    """Speculative decode (k = 3) replays its captured spec step (one
    capture, a replay a spec tick) and gives the eager lane's greedy
    tokens exactly, on both layouts; the target as its own draft accepts
    (nearly) every proposal, and the paged lane's B4 runs only in the
    plain steps (warm-up and fallback ticks)."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    small = GPTForCausalLM(GPTConfig(**MODEL).draft(2, num_layers=1),
                           device=cuda, seed=1).eval()
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(0, MODEL["vocab_size"], n).tolist(), {})
               for n in (5, 9, 14, 16)]
    before = tpa.paged_attention.launches
    lanes = _serve_lanes(model, prompts, new=12, spec_k=3,
                         draft=model if draft == "self" else small,
                         **_LAYOUTS[layout])
    (graphed, eng), (eager, eager_eng) = lanes["graphed"], lanes["eager"]
    assert graphed == eager
    assert all(len(t) == 12 for t in graphed)
    stats = eng.stats()["stats"]
    fn = eng._batcher.spec.spec_step_fn(4, 64)
    assert fn.trace_counter["traces"] == 1
    assert fn.replays == stats["serving.llm.spec.ticks"] > 0
    if draft == "self":
        assert stats["serving.llm.spec.acceptance_rate"] >= 0.9
    launched = tpa.paged_attention.launches - before
    plain = sum(e.stats()["stats"].get("serving.llm.decode_ticks", 0)
                + e.stats()["stats"]["serving.llm.warmup_decode_steps"]
                for e in (eng, eager_eng))
    assert launched == (MODEL["num_layers"] * plain if layout == "paged"
                        else 0)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_graphed_tail_prefill_gives_the_eager_lanes_tokens(cuda, layout):
    """Prefix reuse on the card: the requests sharing a 12-token head hit
    the store and prefill only their tails through the captured tail
    prefill (one capture a bucket), and give the eager lane's tokens;
    an aligned paged hit copies no byte."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    rng = np.random.default_rng(4)
    head = rng.integers(0, MODEL["vocab_size"], 12).tolist()
    prompts = [(head + rng.integers(0, MODEL["vocab_size"], n).tolist(), {})
               for n in (1, 3, 2, 4)]
    lanes = _serve_lanes(model, prompts, one_at_a_time=True,
                         prefix_cache=True, prefix_block=4,
                         **_LAYOUTS[layout])
    (graphed, eng), (eager, _) = lanes["graphed"], lanes["eager"]
    assert graphed == eager
    stats = eng.stats()
    assert stats["stats"]["serving.llm.prefix.hits"] == 3
    assert [eng.decoder.tail_prefill_fn(1, b).trace_counter["traces"]
            for b in (8, 16)] == [1, 1]
    if layout == "paged":
        assert stats["prefix_store"]["bytes_copied"] == 0
        assert stats["prefix_store"]["bytes_shared"] > 0


def test_paged_kernel_over_shared_pages_matches_plain(cuda):
    """B4 on a block table whose rows share pages (a cached head under
    three sequences, each with its own last page), at positions inside
    and at the end of the shared head: within 1e-4 of the plain
    version."""
    rng = np.random.default_rng(21)
    page, h, d, n_pages = 16, 4, 32, 40
    shape = (n_pages + 1, 2, page, h, d)
    ak = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda)
    av = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        cuda)
    bt = np.full((4, 8), n_pages, np.int32)
    bt[:3, :5] = [3, 7, 1, 30, 12]                # the shared head
    bt[:3, 5] = [20, 21, 22]                      # each its own page
    bt[3, :2] = [7, 1]                            # a fourth shares two
    pos = np.array([80, 95, 64, 20], np.int32)
    q = torch.from_numpy(rng.standard_normal((4, h, d),
                                             dtype=np.float32)).to(cuda)
    bt_t, pos_t = torch.from_numpy(bt).to(cuda), torch.from_numpy(pos).to(
        cuda)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt_t, pos_t)
    ref = tpa.paged_attention_plain(q, ak[:, 1], av[:, 1], bt_t, pos_t)
    assert tpa.paged_attention.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4


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


def test_capture_holds_off_collecting_a_dropped_graph(cuda):
    """A dropped program's graph that lives on in a reference cycle (as
    an engine and its worker thread hold one) is not collected inside
    another capture, where destroying it would invalidate that capture:
    here the cycle loses its last outside reference while the second
    program is being captured, with the collector set to run at every
    allocation, and the capture and its replay still hold."""
    import gc
    from paddle_tpu_torch.core import graphs
    old, old_state = graphs.Program(lambda params, state, x: x * 2), \
        _State(cuda)
    old(None, old_state, torch.ones(4, device=cuda))
    assert old.trace_counter["traces"] == 1
    cycle = [old, old_state]
    cycle.append(cycle)
    holder = {"cycle": cycle}
    del old, old_state, cycle
    calls = []

    def raw(params, state, x):
        calls.append(1)
        if len(calls) == 2:                  # the capture, not the warm-up
            holder.clear()
            junk = [[] for _ in range(100)]
            del junk
        return x + 1

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        new, state = graphs.Program(raw), _State(cuda)
        new(None, state, torch.ones(4, device=cuda))
        out = new(None, state, torch.full((4,), 2.0, device=cuda))
    finally:
        gc.set_threshold(*thresholds)
    assert new.trace_counter["traces"] == 1 and new.replays == 1
    assert torch.equal(out, torch.full((4,), 3.0, device=cuda))
    assert gc.isenabled()


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


# -- int8 serving and the quantization package --------------------------------

_INT8 = {"w8": ("int8", "float32"), "kv8": ("float32", "int8"),
         "w8kv8": ("int8", "int8")}


def _spread_model(cuda):
    """The small GPT with weights spread wider than its init, so greedy
    tokens vary from step to step."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, 0.3 / MODEL["hidden_size"] ** 0.5 * 4,
                          generator=gen)
    return model


@pytest.mark.parametrize("combo", list(_INT8))
@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_graphed_int8_engine_gives_the_eager_lanes_tokens(cuda, layout,
                                                          combo):
    """int8 weights, int8 KV and both, on each layout: the captured decode
    step (one capture, a replay a tick) gives the eager lane's greedy
    tokens bitwise; on the paged layout B4 launches once a layer a step
    with dense pages and never over int8 pages ("auto" takes the gather
    lane there); int8 KV holds >= 1.8x fp32's sequences in its bytes."""
    w, kvd = _INT8[combo]
    model = _spread_model(cuda)
    rng = np.random.default_rng(11)
    prompts = [(rng.integers(0, MODEL["vocab_size"], n).tolist(), {})
               for n in (5, 7, 10, 13)]
    before = tpa.paged_attention.launches
    cfg = dict(weight_dtype=w, kv_dtype=kvd)
    if layout == "paged":
        cfg.update(kv_layout="paged", page_size=4)
    lanes = _serve_lanes(model, prompts, **cfg)
    (graphed, eng), (eager, eager_eng) = lanes["graphed"], lanes["eager"]
    assert graphed == eager
    assert all(len(t) == 8 for t in graphed)
    fn = eng.decoder.decode_fn(4, 64)
    assert fn.trace_counter["traces"] == 1
    assert fn.replays == eng.stats()["stats"]["serving.llm.decode_ticks"]
    launched = tpa.paged_attention.launches - before
    if layout == "paged" and kvd == "float32":
        assert eng.decoder.attn_impl == "kernel"
        assert launched == MODEL["num_layers"] * (_steps(eng)
                                                  + _steps(eager_eng))
    else:
        assert launched == 0
    if kvd == "int8":
        assert eng._batcher.kv.quantized
        if layout == "paged":
            assert eng.decoder.attn_impl == "gather"
        dense = eng.decoder.__class__(model, **(
            {"page_size": 4} if layout == "paged" else {})).new_kv(4, 64)
        assert dense.kv_bytes() / eng.stats()["kv_bytes"] >= 1.8


def _dequantized_model(model):
    """A float copy of ``model`` whose projection weights are the int8
    engine's dequantized ``q * s``."""
    from paddle_tpu_torch.quantization import quantize_weight_int8
    twin = GPTForCausalLM(GPTConfig(**MODEL), device=model.gpt.word_embeddings
                          .weight.device, seed=0).eval()
    twin.load_state_dict(model.state_dict())
    with torch.no_grad():
        for lyr in twin.gpt.decoder.layers:
            a = lyr.self_attn
            for lin in (a.q_proj, a.k_proj, a.v_proj, a.out_proj,
                        lyr.linear1, lyr.linear2):
                q, s = quantize_weight_int8(lin.weight, quant_axis=1)
                lin.weight.copy_(q.float() * s)
    return twin


def _parts_at_near_ties(model, prompts, ref, got, noise=1e-3):
    """Where ``got`` parts from ``ref``, the plain forward's top-2 logits
    at the first differing step lie within ``noise``."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import prefill_forward
    dec = GPTStaticDecoder(model)
    for p, a, b in zip(prompts, ref, got):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = torch.tensor([list(p) + list(a[:t])], dtype=torch.int32,
                           device=dec.device)
        with torch.no_grad():
            lraw, _, _ = prefill_forward(dec.spec, dec.params(), seq,
                                         torch.tensor([seq.shape[1]],
                                                      dtype=torch.int32,
                                                      device=dec.device))
        top = lraw[0].topk(2).values
        assert float(top[0] - top[1]) <= noise


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_int8_weight_tokens_match_the_dequantized_fp32_engine(cuda, layout):
    """An int8-weight engine multiplies by the codes and scales the
    product; an fp32 engine over the dequantized weights ``q * s`` differs
    from it only by the reassociated rounding, so their greedy tokens are
    equal but where the fp32 lane's top two logits nearly tie."""
    model = _spread_model(cuda)
    twin = _dequantized_model(model)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, MODEL["vocab_size"], n).tolist()
               for n in (5, 9, 14, 20)]
    cfg = ({"kv_layout": "paged", "page_size": 4} if layout == "paged"
           else {})
    out = {}
    for name, m, w in (("int8", model, "int8"), ("deq", twin, "float32")):
        eng = LLMEngine(m, LLMEngineConfig(
            num_slots=4, max_seq=64, prefill_buckets=(8, 16, 32),
            weight_dtype=w, **cfg))
        try:
            out[name] = [eng.generate(p, max_new_tokens=10)["tokens"]
                         for p in prompts]
        finally:
            eng.drain(timeout=60)
    _parts_at_near_ties(twin, prompts, out["deq"], out["int8"])


def test_int8_kv_row_error_within_two_percent(cuda):
    """One decode step from the same state, fp32 KV against int8 KV: the
    rows the int8 step writes dequantize within 2% of the fp32 rows'
    range (the JAX package's bar)."""
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.kvcache import (dequantize_kv,
                                                      quantize_kv_rows)
    model = _spread_model(cuda)
    d32 = GPTStaticDecoder(model)
    d8 = GPTStaticDecoder(model, kv_dtype="int8")
    k32, k8 = d32.new_kv(2, 16), d8.new_kv(2, 16)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    for buf32, buf8 in ((k32.k, k8.k), (k32.v, k8.v)):
        x = torch.randn(buf32.shape, generator=gen, device=cuda) * 0.3
        q = quantize_kv_rows(x)
        buf8["q"].copy_(q["q"])
        buf8["s"].copy_(q["s"])
        buf32.copy_(dequantize_kv(q))
    for kv in (k32, k8):
        kv.lengths.copy_(torch.tensor([3, 11], dtype=torch.int32))
    last = torch.tensor([5, 7], dtype=torch.int32, device=cuda)
    d32.decode_logits(k32, d32.params(), last)
    d8.decode_logits(k8, d8.params(), last)
    ref = torch.stack([k32.k, k32.v])
    got = torch.stack([dequantize_kv(k8.k), dequantize_kv(k8.v)])
    err = float((ref - got).abs().max() / ref.abs().max())
    assert err < 0.02, err


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (7, 24, 33), (16, 16, 16),
                                   (17, 100, 130), (256, 768, 3072)])
def test_int8_matmul_on_the_card_is_the_exact_product(cuda, m, k, n):
    """``torch._int_mm``'s shape rules on the card (more than 16 rows; K
    and N multiples of 8) are met by padding with zero codes: the int32
    product equals the exact one (float64 on the card) bit for bit."""
    from paddle_tpu_torch.quantization import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    got = int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got, int8_matmul_plain(a, b))
    assert torch.equal(got.cpu(), (a.cpu().long() @ b.cpu().long()).int())


@pytest.mark.parametrize("act", [None, 3.0], ids=["weight_only", "int8"])
def test_int8_linear_on_the_card_matches_the_cpu(cuda, act):
    """Int8Linear on the card against the same layer on the CPU: the int8
    lane's int32 product exactly, the output at 1e-5."""
    from paddle_tpu_torch.quantization import Int8Linear
    g = torch.Generator().manual_seed(14)
    w, b = torch.randn(40, 24, generator=g), torch.randn(24, generator=g)
    x = torch.randn(3, 19, 40, generator=g)
    cpu = Int8Linear.from_float(w, bias=b, act_scale=act)
    card = Int8Linear.from_float(w.to(cuda), bias=b.to(cuda), act_scale=act)
    assert torch.equal(card.weight_q.cpu(), cpu.weight_q)
    torch.testing.assert_close(card(x.to(cuda)).cpu(), cpu(x), rtol=1e-5,
                               atol=1e-5)


def test_requantized_int8_weights_reach_the_captured_decode_step(cuda):
    """The int8 decoder's programs bind its code and scale tensors; after
    an in-place weight change ``params()`` re-quantizes into them, and
    the replayed step equals the eager step on the new weights bitwise."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.serving import ExecutableCache
    from paddle_tpu_torch.serving.llm import GPTStaticDecoder
    from paddle_tpu_torch.serving.llm.decode import (SamplingParams,
                                                     pack_sampling)
    model = _spread_model(cuda)
    dec = GPTStaticDecoder(model, max_top_k=0, weight_dtype="int8",
                           exec_cache=ExecutableCache())
    kv = dec.new_kv(4, 64)
    p = dec.params()
    fin = torch.zeros(4, dtype=torch.bool, device=cuda)
    samp = pack_sampling([SamplingParams()] * 4, cuda)
    last = torch.tensor([3, 9, 1, 2], dtype=torch.int32, device=cuda)
    kv.lengths.copy_(torch.tensor([4, 8, 1, 20], dtype=torch.int32))
    for _ in range(2):                       # capture, then a replay
        dec.decode_step(kv, p, fin, last, samp, None)
    fn = dec.decode_fn(4, 64)
    assert fn.trace_counter["traces"] == 1 and fn.replays == 1
    with torch.no_grad():
        for q in model.parameters():
            q.mul_(-1.25)
    assert dec.params() is not None
    saved = kv.lengths.clone()
    with graphs.disable_graphs():
        ref = dec.decode_logits(kv, dec.params(), last).argmax(-1)
    kv.lengths.copy_(saved)
    got, _ = dec.decode_step(kv, dec.params(), fin, last, samp, None)
    assert fn.replays == 2
    assert torch.equal(got.long(), ref)


# -- the hapi loop: the other optimizer rules, eval programs, EMA and
# -- incubate wrappers, the DataLoader --------------------------------------

LENET_X = np.random.default_rng(11).random((6, 16, 1, 28, 28),
                                           dtype=np.float32)
LENET_Y = np.random.default_rng(12).integers(0, 10, (6, 16))

_RULES = {
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05)),
    "adadelta": ("Adadelta", dict(learning_rate=0.5)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "lamb": ("Lamb", dict(learning_rate=0.01)),
    "lars": ("LarsMomentum", dict(learning_rate=0.1)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.02)),
}


def _lenet_model(cuda, rule="adamax", metrics=None):
    from paddle_tpu_torch import Model, nn, optimizer
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet(device=cuda, seed=0)
    cls, kw = _RULES[rule]
    model = Model(net, device=cuda)
    model.prepare(getattr(optimizer, cls)(parameters=net.parameters(),
                                          device=cuda, **kw),
                  nn.CrossEntropyLoss(), metrics=metrics)
    return model, net


def _state(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_graphed_rule_train_batch_equals_the_eager_lane(cuda, rule):
    """Each of the seven rules (and centered RMSProp) inside the captured
    train step: five replays against five eager steps, losses, weights
    and optimizer state bitwise (cuDNN deterministic)."""
    from paddle_tpu_torch.core import graphs
    res = {}
    for lane in ("graphed", "eager"):
        model, net = _lenet_model(cuda, rule)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cudnn_deterministic():
            losses = [model.train_batch([x], [y])[0]
                      for x, y in zip(LENET_X[:5], LENET_Y[:5])]
        opt = {k: v.clone() for k, v in model._optimizer.state_dict().items()
               if isinstance(v, torch.Tensor)}
        res[lane] = (losses, _state(net), opt, model)
    prog = res["graphed"][3]._train_step_fn["fn"]
    assert prog.trace_counter["traces"] == 1 and prog.replays == 4
    assert res["graphed"][0] == res["eager"][0]
    assert all(np.isfinite(res["graphed"][0]))
    for i in (1, 2):
        for k, v in res["eager"][i].items():
            assert torch.equal(res["graphed"][i][k], v), k


def test_captured_eval_program_equals_eager_eval_batch(cuda):
    """eval_batch and predict_batch replay one captured program per
    signature: the loss and top-k accuracy bitwise those of the eager
    lane; BERT's eval program launches B1 once a layer a call."""
    from paddle_tpu_torch import metric
    from paddle_tpu_torch.core import graphs
    model, _ = _lenet_model(cuda, metrics=metric.Accuracy(topk=(1, 5)))
    with _cudnn_deterministic():
        model.train_batch([LENET_X[0]], [LENET_Y[0]])
        graphed = [model.eval_batch([x], [y]) for x, y in
                   zip(LENET_X[1:4], LENET_Y[1:4])]
        pred = model.predict_batch([LENET_X[1]])
        with graphs.disable_graphs():
            eager = [model.eval_batch([x], [y]) for x, y in
                     zip(LENET_X[1:4], LENET_Y[1:4])]
            epred = model.predict_batch([LENET_X[1]])
    assert len(model._eval_fns) == 2
    ef = model._eval_fns[next(iter(model._eval_fns))]["fn"]
    assert ef.trace_counter["traces"] == 1 and ef.replays == 2
    for (gl, gm), (el, em) in zip(graphed, eager):
        assert gl == el
        np.testing.assert_array_equal(gm[0], em[0])
    assert pred.is_cuda and torch.equal(pred, epred)
    bert, _ = _bert_model(cuda)
    ids = torch.from_numpy(BERT_IDS[0]).to(cuda)
    before = tfa.flash_attention_fwd.launches
    losses = [bert.eval_batch([ids], [ids])[0] for _ in range(3)]
    assert tfa.flash_attention_fwd.launches - before == 3 * \
        BERT_SMALL["num_layers"]
    with graphs.disable_graphs():
        assert bert.eval_batch([ids], [ids])[0] == losses[0] == losses[2]


def _ptrs(net):
    return [p.data_ptr() for p in net.parameters()]


@pytest.mark.parametrize("wrapper", ["ema", "model_average", "lookahead"])
def test_averaging_wrappers_keep_addresses_and_captured_eval_reads_them(
        cuda, wrapper):
    """EMA, ModelAverage and LookAhead copy into the parameters in place:
    the addresses never change, and an eval program captured before
    ``apply`` reads the averaged weights (its loss equal to the eager
    lane's under the same ``apply``); graphed training with the wrapper
    equals its eager lane bitwise."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.incubate.optimizer import LookAhead, ModelAverage
    from paddle_tpu_torch.optimizer import ExponentialMovingAverage
    res = {}
    for lane in ("graphed", "eager"):
        model, net = _lenet_model(cuda, "adamax")
        ptrs = _ptrs(net)
        if wrapper == "ema":
            w = ExponentialMovingAverage(0.8, parameters=net.parameters())
            after = w.update
        elif wrapper == "model_average":
            w = ModelAverage(0.5, parameters=net.parameters(),
                             min_average_window=2, max_average_window=3)
            after = w.step
        else:
            w = LookAhead(model._optimizer, alpha=0.5, k=2)
            w._track()
            after = w._after_inner_step
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx, _cudnn_deterministic():
            for x, y in zip(LENET_X[:5], LENET_Y[:5]):
                model.train_batch([x], [y])
                after()
            plain = model.eval_batch([LENET_X[5]], [LENET_Y[5]])[0]
            if wrapper == "lookahead":
                applied = plain
            else:
                with w.apply():
                    applied = model.eval_batch([LENET_X[5]],
                                               [LENET_Y[5]])[0]
                    assert _ptrs(net) == ptrs
            again = model.eval_batch([LENET_X[5]], [LENET_Y[5]])[0]
        assert _ptrs(net) == ptrs and again == plain
        if wrapper != "lookahead":
            assert applied != plain
        res[lane] = (plain, applied, _state(net))
    assert res["graphed"][:2] == res["eager"][:2]
    for k, v in res["eager"][2].items():
        assert torch.equal(res["graphed"][2][k], v), k


def test_dataloader_on_cuda_yields_cuda_tensors_through_the_ring(cuda):
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import shm_ring

    class Images(io.Dataset):
        def __init__(self):
            self.x = LENET_X.reshape(-1, 1, 28, 28)
            self.y = LENET_Y.reshape(-1)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return len(self.x)

    assert shm_ring.available()
    ds = Images()
    dl = io.DataLoader(ds, batch_size=16, num_workers=2, timeout=30,
                       device=cuda)
    got = list(dl)
    assert dl.stats["shm"] == 6 and dl.stats["queue"] == 0
    for i, (x, y) in enumerate(got):
        assert x.is_cuda and y.is_cuda and y.dtype == torch.int64
        np.testing.assert_array_equal(x.cpu().numpy(), LENET_X[i])
        np.testing.assert_array_equal(y.cpu().numpy(), LENET_Y[i])
    single = list(io.DataLoader(ds, batch_size=16, device=cuda))
    assert all(torch.equal(a[0], b[0]) for a, b in zip(got, single))


# -- the Tensor and its dispatch funnel on the card --------------------------

@pytest.fixture
def port_device():
    """The port's device choice, put back after the test."""
    from paddle_tpu_torch.core import device as tdevice
    saved = tdevice._CURRENT[0]
    yield tdevice
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", ["arith", "compare", "reduce", "matmul",
                                  "index", "setitem", "unary"])
def test_tensor_ops_on_the_card_match_the_cpu(cuda, port_device, case):
    """The same Tensor program on the card and on the CPU: values and
    gradients within 1e-5 (float32, TF32 off)."""
    import paddle_tpu_torch as P
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 2.0, (4, 8)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (8,)).astype(np.float32)
    progs = {
        "arith": lambda x, y: (x + y) * 2 - y / x + x ** 2 - 1.5 / y,
        "compare": lambda x, y: ((x > y) & (x <= 1.5)).astype("float32")
        * x,
        "reduce": lambda x, y: x.sum(axis=1) + x.mean() - x.max(axis=0)[0]
        + P.min(x),
        "matmul": lambda x, y: P.matmul(x, x, transpose_y=True) @ x,
        "index": lambda x, y: x[1:3, ::2] * x[x > 1.0].sum(),
        "setitem": lambda x, y: _setitem_prog(x, y),
        "unary": lambda x, y: P.tanh(P.exp(-x)) + P.sqrt(x) + P.log(x)
        + P.clip(x, 0.7, 1.2) + P.scale(P.abs(-x), 0.5, 1.0),
    }
    out = {}
    for place in ("cpu", "gpu:0"):
        P.set_device(place)
        x = P.to_tensor(a, stop_gradient=False)
        y = P.to_tensor(b, stop_gradient=False)
        z = progs[case](x, y)
        z.sum().backward()
        out[place] = [z.numpy()] + [t.grad.numpy() for t in (x, y)
                                    if t.grad is not None]
    assert x.place == P.CUDAPlace(0) and z.place == P.CUDAPlace(0)
    for c, g in zip(out["cpu"], out["gpu:0"]):
        np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-5)


def _setitem_prog(x, y):
    h = x * 1.0
    h[0] = y * 3
    h[1, 2:4] = 0.5
    return h * x


def test_to_tensor_lands_on_the_card_by_default(cuda, port_device):
    import paddle_tpu_torch as P
    port_device._CURRENT[0] = None
    t = P.to_tensor([1.0, 2.0])
    assert t._data.device == torch.device("cuda", 0)
    assert t.place == P.CUDAPlace(0) and P.get_device() == "gpu:0"
    assert P.zeros([2]).place == P.CUDAPlace(0)


def test_dygraph_gpt_step_on_the_card_launches_b1_b3_per_layer(cuda,
                                                                port_device):
    """One dygraph step of the 2-layer flash GPT on Tensors: B1, B2 and
    B3 launch once per layer on the card (none on the CPU); the loss
    matches the same step on the CPU at 1e-4 and every gradient within
    1e-3 of its tensor's largest (at least a hundredth of the largest
    gradient of the model: k_proj.bias's is zero but for rounding)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    ids = np.random.default_rng(3).integers(0, 256, (2, 64))
    kernels = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv)
    res, weights = {}, None
    for place in ("cpu", "gpu:0"):
        P.set_device(place)
        net = GPTForCausalLM(GPTConfig(**MODEL, attn_impl="flash"),
                             seed=0)
        # the CPU's weights on both (each device's generator draws its own)
        if weights is None:
            weights = {k: v.clone() for k, v in net.state_dict().items()}
        else:
            net.load_state_dict(weights)
        opt = topt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         weight_decay=0.01,
                         grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
        before = [f.launches for f in kernels]
        x = P.to_tensor(ids)
        loss = GPTPretrainingCriterion()(net(x), x)
        loss.backward()
        grads = {n: p.grad.cpu().numpy() for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        assert all(p.grad is None for p in net.parameters())
        launched = [f.launches - b for f, b in zip(kernels, before)]
        res[place] = (float(loss), grads, launched)
    assert res["gpu:0"][2] == [MODEL["num_layers"]] * 3
    assert res["cpu"][2] == [0, 0, 0]
    np.testing.assert_allclose(res["gpu:0"][0], res["cpu"][0], rtol=1e-4)
    top = max(float(np.abs(g).max()) for g in res["cpu"][1].values())
    for k, g in res["cpu"][1].items():
        scale = max(float(np.abs(g).max()), 1e-2 * top)
        np.testing.assert_allclose(res["gpu:0"][1][k], g, rtol=0,
                                   atol=1e-3 * scale, err_msg=k)


def test_check_nan_inf_raises_eagerly_and_is_skipped_under_capture(
        cuda, port_device):
    """FLAGS_check_nan_inf: an eager op on the card that makes an inf
    raises naming the op; inside a CUDA graph capture the check is
    skipped (its values do not exist yet, and a sync would break the
    capture), so the capture succeeds and its replay gives the non-finite
    values without raising."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core.errors import EnforceNotMet
    from paddle_tpu_torch.nn import functional as F
    P.set_device("gpu:0")
    w = torch.randn(8, 8, device=cuda)
    a = torch.ones(4, 8, device=cuda)

    def step():
        return F.softmax(F.linear(a, w) / 0.0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                               # warm-up, flag off
    torch.cuda.current_stream().wait_stream(side)
    P.set_flags({"FLAGS_check_nan_inf": True})
    try:
        x = P.to_tensor([1.0, 0.0])
        with pytest.raises(EnforceNotMet, match="'divide'"):
            x / P.to_tensor([0.0, 0.0])
        with pytest.raises(EnforceNotMet, match="'linear'|'softmax'"):
            step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        graph.replay()
        torch.cuda.synchronize()
    finally:
        P.set_flags({"FLAGS_check_nan_inf": False})
    assert not bool(torch.isfinite(out).all())


def test_capture_with_check_nan_inf_on_succeeds(cuda, port_device):
    """With the flag on throughout, a finite step's warm-up checks its
    outputs and its capture skips the check: one capture, replays equal
    the eager result."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.nn import functional as F
    w = torch.randn(8, 8, device=cuda)
    a = torch.randn(4, 8, device=cuda)
    prog = graphs.Program(lambda params, state, a: F.softmax(
        F.linear(a, params[0])))
    P.set_flags({"FLAGS_check_nan_inf": True})
    try:
        state = _State(cuda)
        first = prog([w], state, a).clone()
        again = prog([w], state, a)
    finally:
        P.set_flags({"FLAGS_check_nan_inf": False})
    assert prog.trace_counter["traces"] == 1 and prog.replays == 1
    torch.testing.assert_close(again, first, rtol=0, atol=0)


# -- the op table (``tests/test_torch_op_table.py``) on the card: each
# case on CUDA against the CPU, and the random ops by seed and moments. --

@pytest.mark.parametrize("case", CUDA_CASES, ids=repr)
def test_op_table_on_the_card_matches_the_cpu(cuda, case):
    import paddle_tpu_torch as P
    cuda_case_holds(case, P)


def test_random_ops_on_the_card_repeat_under_seed_and_hold_moments(cuda):
    """The random creation ops on the card: equal draws after the same
    ``seed``, and their bounds and moments."""
    import paddle_tpu_torch as P
    failures = random_ops_hold(P, "gpu")
    assert not failures, failures


# -- the structured half: host ops, draws, control flow, CRF, beam ----------

@pytest.mark.parametrize("case", HOST_CASES, ids=repr)
def test_host_reading_ops_run_eagerly_on_the_card(cuda, case):
    """The ops that read lengths or tags on the host, run eagerly on CUDA
    tensors: the CPU's results."""
    import paddle_tpu_torch as P
    cuda_case_holds(case, P)


def test_structured_random_ops_on_the_card_repeat_under_seed(cuda):
    """The structured half's draws on the card: on CUDA, equal after the
    same ``seed``, and a ``seed`` argument independent of it."""
    import paddle_tpu_torch as P
    failures = structured_draws_hold(P, "gpu")
    assert not failures, failures


def _cond_model(cuda, loop=False):
    import paddle_tpu_torch as P
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.optimizer import SGD
    P.seed(0)
    net = cond_net(P, loop)
    model = Model(net)
    model.prepare(SGD(learning_rate=0.05, parameters=net.parameters()),
                  lambda pred, y: ((pred - y) ** 2).mean())
    return model, net


def test_cond_under_a_model_capture_matches_eager(cuda):
    """``Model.train_batch`` whose forward calls ``ops.cond``: the captured
    program selects between both branches with no host read; its losses
    and weights bitwise those of the eager lane, which reads the
    predicate; no NaN from the branch not taken."""
    from paddle_tpu_torch.core import graphs
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.random((8, 4), dtype=np.float32)).to(cuda)
    Y = torch.from_numpy(rng.random((8, 1), dtype=np.float32)).to(cuda)
    out = []
    for lane in ("graphed", "eager"):
        model, net = _cond_model(cuda)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx:
            losses = [model.train_batch([X], [Y])[0] for _ in range(5)]
        out.append((losses, [p.detach().clone() for p in net.parameters()]))
        if lane == "graphed":
            fn = model._train_step_fn["fn"]
            assert fn.trace_counter["traces"] == 1 and fn.replays >= 3
    (gl, gp), (el, ep) = out
    assert gl == el and all(np.isfinite(gl)) and gl[-1] < gl[0]
    for a, b in zip(gp, ep):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_while_loop_raises_under_a_model_capture(cuda):
    from paddle_tpu_torch.core import graphs
    X = torch.ones((2, 4), device=cuda)
    model, _ = _cond_model(cuda, loop=True)
    with graphs.disable_graphs():
        assert np.isfinite(model.train_batch([X], [X[:, :1]])[0])
    model, _ = _cond_model(cuda, loop=True)
    with pytest.raises(NotImplementedError, match="trip count"):
        model.train_batch([X], [X[:, :1]])


def _tagger(cuda, dropout):
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import BertConfig, BertModel
    from paddle_tpu_torch.optimizer import AdamW
    cfg = BertConfig(**BERT_SMALL, hidden_dropout_prob=dropout,
                     attention_dropout_prob=dropout)
    import paddle_tpu_torch as P
    P.seed(0)
    torch.manual_seed(0)
    net, loss = bert_crf_tagger(P, BertModel(cfg, device=cuda, seed=0),
                                cfg.hidden_size)
    model = Model(net)
    model.prepare(AdamW(learning_rate=1e-4, parameters=net.parameters()),
                  loss)
    return model


def test_bert_crf_tagger_graphed_equals_eager_and_predict_launches_b1(cuda):
    """The BERT-CRF tagger: ``train_batch`` graphed and eager bitwise
    (dropout 0.1, dense attention, no kernel), the captured predict
    program's Viterbi paths bitwise the eager lane's, B1 once a layer a
    predict call."""
    from paddle_tpu_torch.core import graphs
    rng = np.random.default_rng(2)
    n = rng.integers(32, 65, 4)
    ids = torch.from_numpy(rng.integers(0, BERT_SMALL["vocab_size"],
                                        (4, 64))).to(cuda)
    lens = torch.from_numpy(n).to(cuda)
    tags = torch.from_numpy(iob_tags(rng, n, 64)).to(cuda)
    out = []
    for lane in ("graphed", "eager"):
        model = _tagger(cuda, 0.1)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        before = [c.launches for c in (tfa.flash_attention_fwd,
                                       tfa.flash_attention_bwd_dq)]
        with ctx:
            losses = [model.train_batch([ids, lens], [tags])[0]
                      for _ in range(3)]
        assert [c.launches for c in (tfa.flash_attention_fwd,
                                     tfa.flash_attention_bwd_dq)] == before
        out.append((losses, model))
    (gl, gm), (el, em) = out
    assert gl == el and all(np.isfinite(gl))
    before = tfa.flash_attention_fwd.launches
    paths = [gm.predict_batch([ids, lens])[2] for _ in range(2)]
    assert tfa.flash_attention_fwd.launches - before == \
        2 * BERT_SMALL["num_layers"]
    with graphs.disable_graphs():
        epath = gm.predict_batch([ids, lens])[2]
    assert torch.equal(paths[1], epath) and paths[1].dtype == torch.int64
    assert int(paths[1].max()) < NER_TAGS


def test_dynamic_decode_on_the_card_matches_the_cpu(cuda):
    """A tiny GPT beam-decoded on the card with the cached cell (its
    ``Cache`` leaves reordered by parent every step) and the full-prefix
    cell (B1 once a layer a step): the CPU's scores at 1e-4 and its ids,
    unless two beams lie within 1e-4 (a near tie)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as tdevice
    net = GPTForCausalLM(GPTConfig(**dict(MODEL, hidden_size=256)),
                         device="cpu", seed=0).eval()
    prompts = np.random.default_rng(3).integers(0, 256, (2, 12))
    prompts[:, -1] = 5
    saved = tdevice._CURRENT[0]
    res = {}
    try:
        for place in ("cpu", "gpu"):
            P.set_device(place)
            model = net.to("cuda" if place == "gpu" else "cpu")
            for cached in (True, False):
                cell, inits = gpt_beam_cells(P, model, prompts, cached)
                before = tfa.flash_attention_fwd.launches
                dec = P.nn.BeamSearchDecoder(cell, 5, 255, 4)
                ids, sc = P.nn.dynamic_decode(dec, inits=inits,
                                              max_step_num=6)
                res[place, cached] = (ids.numpy(), sc.numpy(),
                                      tfa.flash_attention_fwd.launches
                                      - before)
    finally:
        tdevice._CURRENT[0] = saved
    for cached in (True, False):
        # equal ids, or beams that swapped on a near tie: scores agree
        np.testing.assert_allclose(res["gpu", cached][1],
                                   res["cpu", cached][1], rtol=1e-4)
        if not np.array_equal(res["gpu", cached][0], res["cpu", cached][0]):
            gap = np.abs(np.diff(res["cpu", cached][1], axis=1)).min()
            assert gap < 1e-4, (cached, res["gpu", cached][0],
                                res["cpu", cached][0])
    assert res["gpu", True][2] == 0
    assert res["gpu", False][2] == 6 * MODEL["num_layers"]


# -- the rest of the nn layers (A3) ---------------------------------------------

@pytest.mark.parametrize("case", LAYER_CASES, ids=repr)
def test_layer_table_on_the_card_matches_the_cpu(cuda, case):
    """Each A3 layer case on CUDA against the CPU from the same state:
    outputs, state after the call and gradients."""
    import paddle_tpu_torch as P
    layer_case_holds(case, P)


def _mlp_model(cuda, seed, hook=None):
    import paddle_tpu_torch as P
    P.seed(seed)
    net = P.nn.Sequential(P.nn.Linear(8, 16, device=cuda), P.nn.GELU(),
                          P.nn.Linear(16, 4, device=cuda))
    if hook is not None:
        net[0].register_forward_post_hook(hook)
    model = P.Model(net)
    model.prepare(P.optimizer.SGD(learning_rate=0.1,
                                  parameters=net.parameters(), device=cuda),
                  P.nn.CrossEntropyLoss())
    return model, net


def _mlp_batch(cuda):
    rng = np.random.default_rng(19)
    return (torch.from_numpy(rng.standard_normal((32, 8), dtype=np.float32)
                             ).to(cuda),
            torch.from_numpy(rng.integers(0, 4, (32,))).to(cuda))


def test_set_state_dict_into_a_captured_program(cuda):
    """``set_state_dict`` copies in place: after the capture, weights set
    through it are what the replays read, so the next graphed step equals
    an eager step from those weights."""
    from paddle_tpu_torch.core import graphs
    x, y = _mlp_batch(cuda)
    model, net = _mlp_model(cuda, 0)
    model.train_batch([x], [y])
    model.train_batch([x], [y])
    ptrs = [p.data_ptr() for p in net.parameters()]
    _, other = _mlp_model(cuda, 1)
    assert net.set_state_dict(other.state_dict()) == ([], [])
    assert [p.data_ptr() for p in net.parameters()] == ptrs
    got = [model.train_batch([x], [y])[0] for _ in range(2)]
    assert model._train_step_fn["fn"].replays == 3
    ref_model, _ = _mlp_model(cuda, 1)
    with graphs.disable_graphs():
        ref = [ref_model.train_batch([x], [y])[0] for _ in range(2)]
    _equal_or_close(got, ref, "losses after set_state_dict")


def test_forward_post_hook_under_train_batch(cuda):
    """A post-hook that scales the first layer's output changes the
    loss the same way in both lanes; its Python runs at every eager step
    but only while the graphed lane captures (a replay runs none)."""
    from paddle_tpu_torch.core import graphs
    x, y = _mlp_batch(cuda)
    res = {}
    for lane in ("graphed", "eager"):
        calls = []

        def hook(layer, inputs, out, calls=calls):
            calls.append(type(out))
            return out * 2.0
        model, _ = _mlp_model(cuda, 0, hook)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        with ctx:
            res[lane] = ([model.train_batch([x], [y])[0] for _ in range(4)],
                         calls)
    _equal_or_close(res["graphed"][0], res["eager"][0], "losses")
    assert len(res["eager"][1]) == 4
    assert 1 <= len(res["graphed"][1]) < 4
    assert set(res["eager"][1]) == {torch.Tensor}
    plain, _ = _mlp_model(cuda, 0)
    with graphs.disable_graphs():
        assert plain.train_batch([x], [y])[0] != res["eager"][0][0]


def test_max_pool2d_mask_on_ties_matches_the_cpu(cuda):
    """Windows of equal maxima: the card's index is the CPU's (the
    first maximum in row-major order; column-major in a window two wide
    with padding at its sides, as the JAX package's)."""
    import paddle_tpu_torch as P
    F = P.nn.functional
    x = np.random.default_rng(4).integers(0, 2, (2, 3, 9, 8)).astype(
        np.float32)
    for kw in (dict(kernel_size=2), dict(kernel_size=3, stride=1,
                                         padding=1),
               dict(kernel_size=[3, 2], stride=[2, 1], padding=1)):
        cpu = F.max_pool2d(torch.from_numpy(x), return_mask=True, **kw)
        gpu = F.max_pool2d(torch.from_numpy(x).to(cuda), return_mask=True,
                           **kw)
        for a, b in zip(gpu, cpu):
            assert torch.equal(a.cpu(), b), kw


# -- A9: the recurrent layers, the detection ops, the input pipeline --------

@pytest.mark.parametrize("case", RNN_CASES, ids=repr)
def test_rnn_table_on_the_card_matches_the_cpu(cuda, case):
    """Each recurrent layer case on CUDA against the CPU from the same
    weights: outputs, final states and gradients."""
    import paddle_tpu_torch as P
    layer_case_holds(case, P)


@pytest.mark.parametrize("case", DET_CASES, ids=repr)
def test_detection_table_on_the_card_matches_the_cpu(cuda, case):
    """Each detection op case on CUDA against the CPU: forward (masks,
    indices, counts bitwise) and gradient."""
    import paddle_tpu_torch as P
    cuda_case_holds(case, P)


def _lm_model(cuda, seed=27, dropout=0.65):
    import paddle_tpu_torch as P
    P.seed(seed)
    net, loss = lstm_lm(P, vocab=500, hidden=64, layers=2, dropout=dropout)
    net.to(cuda)
    model = P.Model(net)
    model.prepare(P.optimizer.SGD(learning_rate=1.0,
                                  parameters=net.parameters(), device=cuda,
                                  grad_clip=P.nn.ClipGradByGlobalNorm(10.0)),
                  loss)
    return model


@pytest.mark.parametrize("o1", [False, True], ids=["fp32", "o1"])
def test_lstm_lm_graphed_equals_eager_on_the_card(cuda, o1):
    """The LSTM LM (2 layers of 64, dropout 0.65) trained 4 steps by
    ``train_batch``: the captured program's losses bitwise the eager
    lane's (the loop and the dropout masks capture), no port kernel
    launched; the eval program's loss equal to the eager one's."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import graphs
    ids = np.random.default_rng(0).integers(0, 500, (4, 8, 13))
    x = torch.from_numpy(ids[..., :-1]).to(cuda)
    y = torch.from_numpy(ids[..., 1:]).to(cuda)
    before = tcustom.greedy_nms.launches + tpa.paged_attention.launches
    losses = {}
    for lane in ("graphed", "eager"):
        model = _lm_model(cuda)
        P.seed(5)
        ctx = graphs.disable_graphs() if lane == "eager" \
            else contextlib.nullcontext()
        amp = P.amp.auto_cast(level="O1", dtype="bfloat16") if o1 \
            else contextlib.nullcontext()
        with ctx, amp:
            losses[lane] = [float(model.train_batch([x[t]], [y[t]])[0])
                            for t in range(4)]
            losses[lane + "_eval"] = [float(model.eval_batch(
                [x[0]], [y[0]])[0]) for _ in range(2)]
    assert losses["graphed"] == losses["eager"]
    assert losses["graphed_eval"] == losses["eager_eval"]
    assert tcustom.greedy_nms.launches + tpa.paged_attention.launches == \
        before


def test_nms_kernel_at_k1000_matches_plain_bit_exactly(cuda):
    """B5 at ``generate_proposals``' k = 1000 (Faster R-CNN's
    ``pre_nms_top_n``), one problem an image, threshold 0.7."""
    iou, valid, thr = _nms_case(1000, 4, 1000, "boxes")
    valid[:] = 1
    thr[:] = 0.7
    ic, vc, tc = iou.to(cuda), valid.to(cuda), thr.to(cuda)
    got = tcustom.greedy_nms(ic, vc, tc, 1.0)
    assert torch.equal(got, tcustom.greedy_nms_plain(ic, vc, tc, 1.0))
    assert torch.equal(got.cpu(), tcustom.greedy_nms_plain(iou, valid, thr,
                                                           1.0))


def test_faster_rcnn_chain_on_the_card_matches_the_cpu(cuda):
    """The RPN-to-NMS chain at a small size on CUDA against the CPU: rois
    and detections equal (kept sets exact), pooled features at 1e-5; B5
    launched once for each level's ``generate_proposals`` (both images in
    one launch) and once for ``multiclass_nms``."""
    import paddle_tpu_torch as P
    cfg = dict(FRCNN, pre_nms_top_n=200, post_nms_top_n=64, keep_top_k=40,
               refer_scale=48)
    feats, scores, deltas, im = frcnn_inputs(size=(96, 128), width=8)
    rng = np.random.default_rng(6)
    r = 2 * cfg["post_nms_top_n"]
    logits = (rng.permutation(r * 6).reshape(r, 6) / (r * 6) * 12 - 6
              ).astype(np.float32)
    box_d = rng.uniform(-0.5, 0.5, (r, 4)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        before = tcustom.greedy_nms.launches
        rois, num = rpn_to_rois(P, [t(f) for f in feats],
                                [t(s) for s in scores],
                                [t(d) for d in deltas], t(im), cfg)
        pooled = roi_features(P, [t(f) for f in feats[:4]], rois, num, cfg)
        dets, counts = detect(P, rois, t(logits), t(box_d),
                              t(np.array(cfg["box_variances"], np.float32)),
                              2, cfg)
        out[str(dev)] = [v.cpu() for v in (rois, pooled, dets, counts)]
        launched = tcustom.greedy_nms.launches - before
    assert launched == len(FRCNN["strides"]) + 1
    (a_r, a_p, a_d, a_c), (b_r, b_p, b_d, b_c) = out["cuda"], out["cpu"]
    torch.testing.assert_close(a_r, b_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(a_p, b_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(a_c, b_c) and torch.equal(a_d[..., 0], b_d[..., 0])
    torch.testing.assert_close(a_d, b_d, rtol=1e-5, atol=1e-4)


def test_roi_align_on_the_card_at_the_p2_tap_grid(cuda):
    """``roi_align`` at a P2-like level (the 8 x 8 tap grid) on 300 rois,
    CUDA against the CPU within 1e-5 of the largest entry, and bitwise
    repeatable."""
    import paddle_tpu_torch as P
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 100, 120)).astype(np.float32)
    xy = rng.uniform(-20, 420, (300, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 300, (300, 2))],
                          1).astype(np.float32)
    kw = dict(spatial_scale=0.25, sampling_ratio=0, aligned=True,
              rois_num=np.array([150, 150]))
    ref = P.ops.roi_align(torch.from_numpy(x), torch.from_numpy(rois), 7,
                          **kw)
    xc, rc = torch.from_numpy(x).to(cuda), torch.from_numpy(rois).to(cuda)
    got = P.ops.roi_align(xc, rc, 7, **kw)
    assert torch.equal(got, P.ops.roi_align(xc, rc, 7, **kw))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def test_transforms_in_loader_workers_feed_the_card(cuda, tmp_path):
    """PaddleClas's train transforms on a ``DatasetFolder`` of ``.npy``
    images through a 2-worker ``DataLoader`` onto the card, run to its
    end: float32 NCHW batches on CUDA."""
    import paddle_tpu_torch as P
    T = P.vision.transforms
    rng = np.random.default_rng(8)
    for c in ("a", "b"):
        (tmp_path / c).mkdir()
        for i in range(4):
            np.save(tmp_path / c / f"{i}.npy", rng.integers(
                0, 256, (20 + i, 24, 3)).astype(np.uint8))
    tf = T.Compose([T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
                    T.Normalize(mean=[123.675, 116.28, 103.53],
                                std=[58.395, 57.12, 57.375],
                                data_format="HWC"), T.Transpose()])
    ds = P.vision.datasets.DatasetFolder(str(tmp_path), transform=tf)
    loader = P.io.DataLoader(ds, batch_size=4, num_workers=2, timeout=60)
    batches = list(loader)
    assert len(batches) == 2
    x, y = batches[0]
    assert x.is_cuda and x.dtype == torch.float32 and \
        tuple(x.shape) == (4, 3, 16, 16)


# -- the host-plane substrate on the card ------------------------------------

def _metered_lane(cuda, meter, dropout):
    from paddle_tpu_torch import Model, amp
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.observability.stepmeter import StepMeter
    from paddle_tpu_torch.optimizer import AdamW
    net = GPTForCausalLM(GPTConfig(**dict(MODEL, hidden_dropout_prob=dropout),
                                   attn_impl="flash"), device=cuda, seed=0)
    m = Model(net, device=cuda)
    m.prepare(AdamW(parameters=net.parameters(), device=cuda),
              GPTPretrainingCriterion())
    reg = StatRegistry()
    ids = np.random.RandomState(3).randint(0, 256, (4, 64))
    import paddle_tpu_torch as P
    P.seed(5)
    losses, flops = [], []
    for i, o1 in enumerate((False, False, True, True)):
        # "late": attached after the fp32 signature's capture
        if meter and i == (1 if meter == "late" else 0):
            m.attach_step_meter(StepMeter(registry=reg, device=cuda))
        with (amp.auto_cast() if o1 else contextlib.nullcontext()):
            losses.append(m.train_batch([ids], [ids])[0])
        flops.append(reg.get("train.flops_per_step"))
    return losses, flops, reg


def test_metered_graphed_train_steps_keep_their_losses(cuda):
    """The step meter counts each signature once, eagerly and never inside
    a capture (before it, or after it for a meter attached late), and
    puts the dropout generator back: the graphed fp32 and O1 losses are
    bitwise those of an unmetered model, and the count is the products
    plus B1-B3's formulas exactly."""
    for dropout in (0.0, 0.1):
        plain, _, _ = _metered_lane(cuda, False, dropout)
        for when in ("late", True):
            metered, flops, reg = _metered_lane(cuda, when, dropout)
            assert metered == plain
    t, s, h, v, layers = 4 * 64, 64, 128, 256, 2
    pairs = tfa.attention_pairs(s, s, True)
    want = 3 * t * (12 * layers * h * h + h * v) \
        + layers * 18 * 4 * h * pairs / 2
    assert flops == [want] * 4
    assert reg.get("train.mfu") > 0
    assert reg.histogram("train.step_ms")["count"] == 4


def test_flash_and_paged_flop_formulas_counted_on_the_card(cuda):
    from paddle_tpu_torch.observability import stepmeter as sm
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _qkv(11, 2, 128, 128, 4, 64))
    for t in (q, k, v):
        t.requires_grad_(True)

    def step():
        out = tfa.FlashAttentionFunction.apply(q, k, v, True, None)
        out.sum().backward()

    before = [w.launches for w in (tfa.flash_attention_fwd,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    _, raw, by = sm.count_flops(step)
    after = [w.launches for w in (tfa.flash_attention_fwd,
                                  tfa.flash_attention_bwd_dq,
                                  tfa.flash_attention_bwd_dkv)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    one = 2 * 2 * 4 * 64 * tfa.attention_pairs(128, 128, True)
    assert by == {"flash_attention_fwd": 2 * one,
                  "flash_attention_bwd_dq": 3 * one,
                  "flash_attention_bwd_dkv": 4 * one}
    assert raw == 9 * one
    qp, kb, vb, bt, pos = (torch.from_numpy(x).to(cuda)
                           for x in _paged_case(12))
    _, raw, by = sm.count_flops(tpa.paged_attention, qp, kb[:, 1],
                                vb[:, 1], bt, pos)
    cap = bt.shape[1] * kb.shape[2]
    rows = int((pos.long() + 1).clamp(max=cap).sum())
    assert by == {"paged_attention": 4.0 * rows * qp.shape[1] * qp.shape[2]}


@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_measure_mfu_keeps_the_engine_tokens(cuda, layout):
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    kw = dict(kv_layout="paged", page_size=16, paged_attn_impl="kernel") \
        if layout == "paged" else {}
    prompts = [[3, 1, 4, 1, 5], list(range(1, 20)), [9, 2]]
    out = {}
    for measure in (False, True):
        eng = LLMEngine(model, LLMEngineConfig(num_slots=4, max_seq=64,
                                               measure_mfu=measure, **kw))
        try:
            reqs = [eng.submit(p, max_new_tokens=12, do_sample=True,
                               temperature=1.3, top_k=16) for p in prompts]
            greedy = eng.generate([7, 7, 7], max_new_tokens=12)["tokens"]
            out[measure] = ([r.result(timeout=120)["tokens"] for r in reqs],
                            greedy)
            st = eng.stats()["stats"]
        finally:
            eng.drain(timeout=60)
    assert out[True] == out[False]
    assert st["serving.llm.decode_flops_per_tick"] > 0
    assert st["serving.llm.mfu"] > 0


def test_sigterm_drains_the_engine_on_the_card(cuda, tmp_path, monkeypatch):
    import signal
    from paddle_tpu_torch import observability as obs
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    eng = LLMEngine(model, LLMEngineConfig(
        num_slots=2, max_seq=64, kv_layout="paged", page_size=16,
        paged_attn_impl="kernel"))
    prev = signal.getsignal(signal.SIGTERM)
    obs.enable()
    chain = eng.install_drain_signal_handler()
    try:
        reqs = [eng.submit([1, 2, 3], max_new_tokens=20, stream=True)] + [
            eng.submit([4 + i], max_new_tokens=10) for i in range(4)]
        it = reqs[0].iter_tokens(timeout=60)
        next(it)
        signal.raise_signal(signal.SIGTERM)
        assert eng.draining
        assert len([next(it)] + list(it)) == 19
        assert [len(r.result(60)["tokens"]) for r in reqs[1:]] == [10] * 4
        assert eng._stopped.wait(60)
    finally:
        chain.uninstall()
        obs.disable()
        eng.drain(timeout=60)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert len(list(tmp_path.glob("flight_*.jsonl"))) == 1


def test_capture_while_a_profiler_runs(cuda, tmp_path):
    """A CUDA graph captured under an active Profiler, its function
    opening the funnel's record_function range inside the capture;
    replays give the product."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core import graphs

    class _State:
        graph_pool = graphs.GraphPool(cuda)

    x = torch.randn(128, 128, device=cuda)
    prog = graphs.Program(lambda params, state, a: P.matmul(a, a))
    with profiler.Profiler(log_dir=str(tmp_path)):
        prog([], _State, x)
        out = prog([], _State, x)
    torch.cuda.synchronize()
    assert prog.trace_counter["traces"] == 1 and prog.replays == 1
    torch.testing.assert_close(out, x @ x)


# -- training that survives faults --------------------------------------------
def _guarded(model, ladder=("skip_step",), rollback=None):
    from paddle_tpu_torch.sentinel import Sentinel, SentinelConfig
    return Sentinel(SentinelConfig(ladder=ladder, warmup_steps=10_000),
                    optimizer=model._optimizer, rollback=rollback)


def _live_state(model):
    out = {k: v.detach().clone() for k, v in
           model.network.state_dict().items()}
    out.update({k: v.clone() for k, v in model._optimizer.state_dict().items()
                if isinstance(v, torch.Tensor)})
    return out


def _same_state(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("precision", ["fp32", "o1"])
def test_guarded_graphed_step_equals_guarded_eager_step(cuda, precision,
                                                        monkeypatch):
    """The sentinel route (captured gradients program, the probe's graph,
    the eager update) against the same route with graphs off, a NaN
    skipped at the third step in both: losses and state bitwise, B1-B3
    once a layer a step."""
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.utils import resilience
    lanes = []
    for eager in (False, True):
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "grads:3:nan")
        resilience._reset_fault_injector_for_tests()
        model, net = _train_model(cuda, precision)
        s = _guarded(model)
        before = _flash_counts()
        losses = []
        with graphs.disable_graphs() if eager else \
                contextlib.nullcontext(), _cast(precision):
            for ids in TRAIN_IDS:
                losses.append(model.train_batch([ids], [ids])[0])
        counts = [a - b for a, b in zip(_flash_counts(), before)]
        lanes.append((losses, _live_state(model), counts, s.anomalies))
        model._invalidate_compiled()
    resilience._reset_fault_injector_for_tests()
    (lg, sg, cg, ag), (le, se, ce, ae) = lanes
    assert lg == le and _same_state(sg, se) and ag == ae == 1
    assert cg == [MODEL["num_layers"] * len(TRAIN_IDS)] * 3


def test_async_snapshot_taken_before_the_next_captured_step(cuda, tmp_path):
    """``save()`` clones on the stream the next graph replay runs on, with
    no host sync; the archive holds the state at ``save()``, not the state
    after the steps queued behind it."""
    from paddle_tpu_torch.incubate.checkpoint import (AsyncCheckpointer,
                                                      load_sharded)
    model, net = _train_model(cuda)
    for ids in TRAIN_IDS[:2]:
        model.train_batch([ids], [ids])          # captured by now
    want = _live_state(model)
    state = {"model": net.state_dict(),
             "optimizer": model._optimizer.state_dict()}
    ck = AsyncCheckpointer()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ticket = ck.save(state, str(tmp_path / "ck"), step=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for ids in TRAIN_IDS[2:]:
        model.train_batch([ids], [ids])          # replays, in place
    assert ticket.wait(120) and ticket.committed
    ck.close()
    out = load_sharded(str(tmp_path / "ck"), return_tensor=False,
                       device=cuda)
    got = dict(out["model"])
    got.update({k: v for k, v in out["optimizer"].items()
                if isinstance(v, torch.Tensor)})
    assert _same_state(got, want)
    assert not torch.equal(net.gpt.word_embeddings.weight,
                           want["gpt.word_embeddings.weight"])


def test_rollback_into_a_live_captured_program(cuda, tmp_path,
                                               monkeypatch):
    """A NaN under the rollback rung restores the newest healthy snapshot
    into the parameters and moments in place; the captured gradients
    program's next replay trains from it: the losses after the rollback
    equal a model loaded from the snapshot."""
    from paddle_tpu_torch.sentinel import CheckpointRollback
    from paddle_tpu_torch.utils import resilience
    model, net = _train_model(cuda, "o1")
    rb = CheckpointRollback(str(tmp_path / "snaps"), model=net,
                            optimizer=model._optimizer, async_save=True)
    s = _guarded(model, ("rollback",), rb)
    with _cast("o1"):
        model.train_batch([TRAIN_IDS[0]], [TRAIN_IDS[0]])
        rb.snapshot(0)
        snap = _live_state(model)
        ptrs = [p.data_ptr() for p in net.parameters()]
        model.train_batch([TRAIN_IDS[1]], [TRAIN_IDS[1]])
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", "grads:1:nan")
        resilience._reset_fault_injector_for_tests()
        model.train_batch([TRAIN_IDS[2]], [TRAIN_IDS[2]])
        monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC")
        resilience._reset_fault_injector_for_tests()
        assert s.last_report.rolled_back_to == 0
        assert _same_state(_live_state(model), snap)
        assert [p.data_ptr() for p in net.parameters()] == ptrs
        after = [model.train_batch([i], [i])[0] for i in TRAIN_IDS[3:]]
    assert model._train_step_fn["grads_fn"].trace_counter["traces"] == 1
    from paddle_tpu_torch.incubate.checkpoint import load_sharded
    ref, rnet = _train_model(cuda, "o1")
    st = load_sharded(str(tmp_path / "snaps" / "snap_0"),
                      return_tensor=False, device="cpu")
    rnet.set_state_dict(st["model"])
    ref._optimizer.set_state_dict(st["optimizer"])
    _guarded(ref)
    with _cast("o1"):
        want = [ref.train_batch([i], [i])[0] for i in TRAIN_IDS[3:]]
    assert after == want


def test_probe_is_one_sync_and_save_none(cuda):
    """The guarded step's one host sync is the probe's fetch: under
    ``set_sync_debug_mode("warn")`` ``approve_step`` warns once, and the
    async checkpointer's ``save()`` not at all."""
    import warnings
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.incubate.checkpoint import async_ckpt
    model, net = _train_model(cuda)
    s = _guarded(model)
    model.train_batch([TRAIN_IDS[0]], [TRAIN_IDS[0]])   # the probe's capture
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    syncs = monitor.stat_get("sentinel.host_syncs")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ok = s.approve_step(model._optimizer)
            snap = async_ckpt.snapshot({"model": net.state_dict()})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    synced = [x for x in w if "synchroniz" in str(x.message)]
    assert ok and len(synced) == 1, [str(x.message) for x in w]
    assert monitor.stat_get("sentinel.host_syncs") == syncs + 1
    host = async_ckpt._host_flat(snap)
    assert all(v.device.type == "cpu" for v in host.values())


# -- the fleet's data path (serving/fleet, paged export and import) -----------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_read_pages_and_write_page_round_trip_bitwise(cuda, kv_dtype):
    """``read_pages`` gathers pages to the host (NumPy, one leaf or the
    int8 pair) and ``write_page`` puts each into another cache's fresh
    page in place: bitwise, the arenas' addresses kept; a shared page is
    refused."""
    from paddle_tpu_torch.serving.llm.kvcache import kv_leaves
    from paddle_tpu_torch.serving.llm.paged import PagedKVCache
    kw = dict(num_slots=2, num_layers=3, max_seq=64, num_heads=4,
              head_dim=32, kv_dtype=kv_dtype, page_size=16, device=cuda)
    src, dst = PagedKVCache(**kw), PagedKVCache(**kw)
    g = torch.Generator(device=cuda).manual_seed(3)
    for t in kv_leaves(src.k) + kv_leaves(src.v):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=cuda, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, device=cuda) + 0.5)
    src.alloc()
    src.ensure_pages(0, 50)
    pids = src.slot_page_ids(0)
    k_pages, v_pages = src.read_pages(pids)
    ptrs = [t.data_ptr() for t in kv_leaves(dst.k) + kv_leaves(dst.v)]
    slot = dst.alloc()
    dst.ensure_pages(slot, 50)
    def page(p, i):
        return {n: p[n][i] for n in p} if isinstance(p, dict) else p[i]
    for i, pid in enumerate(dst.slot_page_ids(slot)):
        dst.write_page(pid, page(k_pages, i), page(v_pages, i))
    assert ptrs == [t.data_ptr() for t in kv_leaves(dst.k) + kv_leaves(dst.v)]
    for a, b in zip(kv_leaves(src.k) + kv_leaves(src.v),
                    kv_leaves(dst.k) + kv_leaves(dst.v)):
        idx_a = torch.tensor(pids, device=cuda)
        idx_b = torch.tensor(dst.slot_page_ids(slot), device=cuda)
        assert a[idx_a].cpu().numpy().tobytes() == \
            b[idx_b].cpu().numpy().tobytes()
    leaf = k_pages["q"] if kv_dtype else k_pages
    assert isinstance(leaf, np.ndarray) and leaf.shape == (4, 3, 16, 4, 32)
    dst.adopt_shared_page(dst.alloc(), dst.slot_page_ids(slot)[0])
    with pytest.raises(ValueError, match="refcount"):
        dst.write_page(dst.slot_page_ids(slot)[0], page(k_pages, 0),
                       page(v_pages, 0))


def test_migrated_sequence_resumes_bitwise_through_the_kernel(cuda):
    """A graphed paged engine's live sequence exported mid-stream and
    imported into a sibling engine (through B4 on both) gives an
    undisturbed engine's tokens bitwise; B4's launches are one a layer a
    decode step over the three engines."""
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    cfg = dict(num_slots=4, max_seq=64, kv_layout="paged", page_size=16,
               paged_attn_impl="kernel", prefill_buckets=(8, 32))
    prompt = list(range(3, 23))
    before = tpa.paged_attention.launches
    engines = [LLMEngine(model, LLMEngineConfig(**cfg)) for _ in range(3)]
    ref_eng, a, b = engines
    try:
        ref = ref_eng.generate(prompt, max_new_tokens=40)["tokens"]
        req = a.submit(prompt, max_new_tokens=40, stream=True)
        deadline = time.monotonic() + 60
        while len(req.tokens) < 5 and time.monotonic() < deadline:
            time.sleep(0.001)
        a.pause_admission()
        man = a.export_sequences(timeout=30)[0]
        assert b.import_sequence(man, timeout=30)
        assert list(req.iter_tokens(timeout=120)) == ref
    finally:
        for e in engines:
            e.drain(timeout=60)
    steps = sum(e.stats()["stats"].get(k, 0) for e in engines
                for k in ("serving.llm.decode_ticks",
                          "serving.llm.warmup_decode_steps"))
    assert tpa.paged_attention.launches - before == \
        MODEL["num_layers"] * steps


def test_a_capture_beside_a_replaying_engine_keeps_both_launch_counts(cuda):
    """C12: an engine's warm-up captures its programs while a sibling
    engine's worker replays its decode step on the same card. Each
    thread's launches land once: B4's count is one a layer a decode step
    of both engines, and both serve their tokens."""
    import threading
    model = GPTForCausalLM(GPTConfig(**dict(MODEL,
                                            max_position_embeddings=256)),
                           device=cuda, seed=0).eval()
    cfg = LLMEngineConfig(num_slots=2, max_seq=256, kv_layout="paged",
                          page_size=16, paged_attn_impl="kernel",
                          prefill_buckets=(8, 64, 128))
    before = tpa.paged_attention.launches
    a = LLMEngine(model, cfg)
    stop = threading.Event()
    served = []

    def pump():
        while not stop.is_set():
            served.append(a.generate([1, 2, 3], max_new_tokens=200))
    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        ticks0 = a.stats()["stats"].get("serving.llm.decode_ticks", 0)
        b = LLMEngine(model, cfg)                  # captures now
        ticks1 = a.stats()["stats"].get("serving.llm.decode_ticks", 0)
        stop.set()
        t.join(timeout=120)
        got = b.generate([1, 2, 3], max_new_tokens=200)["tokens"]
    finally:
        stop.set()
        a.drain(timeout=60)
        b.drain(timeout=60)
    assert ticks1 > ticks0                         # a decoded meanwhile
    assert served and all(s["tokens"] == got for s in served)
    steps = sum(e.stats()["stats"].get(k, 0) for e in (a, b)
                for k in ("serving.llm.decode_ticks",
                          "serving.llm.warmup_decode_steps"))
    assert tpa.paged_attention.launches - before == \
        MODEL["num_layers"] * steps


# -- the tuner's B4 family and the HTTP front door ---------------------------------

@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A fresh winner cache for the tuner, every memo tier reset."""
    from paddle_tpu_torch import tuner
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path))
    tuner.clear_memo()
    yield tmp_path
    tuner.clear_memo()


@pytest.mark.parametrize("bps", [1, 4, 16, 64])
def test_paged_kernel_under_a_winner_matches_plain_and_replays(
        cuda, bps, tune_cache, monkeypatch):
    """A winner in the committed table changes B4's chunking (GPT-3
    1.3B's decode shape: 8 sequences x 16 heads x 128, 64 pages of 16),
    and one only in the disk cache does not: the default launch takes the
    committed one (bitwise the forced target's), stays within 1e-4 of the
    plain version, repeats bitwise, and a CUDA graph captured under it
    replays bitwise the eager launch."""
    import json
    from paddle_tpu_torch import tuner
    from paddle_tpu_torch.core import graphs
    from paddle_tpu_torch.tuner import store
    q, ak, av, bt, _ = (torch.from_numpy(x).to(cuda) for x in _paged_case(
        21, s_n=8, h=16, d=128, page=16, pps=64))
    kb, vb = ak[:, 1], av[:, 1]
    pos = torch.tensor([0, 15, 16, 255, 512, 1023, 640, 1000],
                       dtype=torch.int32, device=cuda)
    key = tuner.paged_key(16, 128, 16, "float32", device=cuda)
    tuner.record_winner(key, {"blocks_per_sm": bps})
    tuner.clear_memo()
    assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                     cuda) is None
    table = tune_cache / "committed.json"
    table.write_text(json.dumps({
        "version": tuner.CACHE_VERSION, "platform": "defaults",
        "entries": {key: {"config": {"blocks_per_sm": bps},
                          "note": "a test's"}}}))
    monkeypatch.setattr(store, "_DEFAULTS_FILE", str(table))
    tuner.clear_memo()
    assert tuner.paged_blocks_per_sm(16, 128, 16, torch.float32,
                                     cuda) == bps
    out = tpa.paged_attention(q, kb, vb, bt, pos)
    forced = tpa.paged_attention(q, kb, vb, bt, pos, blocks_per_sm=bps)
    again = tpa.paged_attention(q, kb, vb, bt, pos)
    ref = tpa.paged_attention_plain(q, kb, vb, bt, pos)
    assert torch.equal(out, forced) and torch.equal(out, again)
    assert (out - ref).abs().max().item() <= 1e-4
    prog = graphs.Program(lambda params, state, q, positions:
                          tpa.paged_attention(q, kb, vb, bt, positions))
    state = _State(cuda)
    prog(None, state, q.clone(), pos.clone())
    before = tpa.paged_attention.launches
    for _ in range(3):
        assert torch.equal(prog(None, state, q.clone(), pos.clone()), out)
    assert prog.replays == 3 and tpa.paged_attention.launches == before + 3


def test_autotune_paged_attn_records_a_winner_read_back(cuda, tune_cache):
    """The search on the card: every candidate within B4's limits timed on
    the device's clock, the rule's among them, its launches counted; by
    default nothing is written, and with ``record`` the winner goes to
    the platform's file and is read back from disk, while B4's launch
    path keeps the rule."""
    from paddle_tpu_torch import tuner
    tag = tuner.platform_tag(cuda)
    assert tag.startswith("cuda-sm")
    tuner.autotune_paged_attn(4, 4, 32, 16, pages_per_seq=8, trials=1,
                              iters=2, device=cuda)
    assert not (tune_cache / f"winners-{tag}.json").exists()
    before = tpa.paged_attention.launches
    res = tuner.autotune_paged_attn(4, 4, 32, 16, pages_per_seq=8,
                                    trials=2, iters=5, record=True,
                                    device=cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = tuner.paged_attn_candidates(4, 4, 8, n_sms)
    assert {"blocks_per_sm": res["blocks_per_sm"]} in cands
    assert set(res["results"]) <= {repr(c) for c in cands}
    assert repr({"blocks_per_sm": tpa.BLOCKS_PER_SM}) in res["results"]
    assert res["us"] == min(res["results"].values()) * 1e6 > 0
    assert tpa.paged_attention.launches - before == res["launches"] > 0
    assert (tune_cache / f"winners-{tag}.json").exists()
    tuner.clear_memo()
    assert tuner.get_paged_attn_config(4, 32, 16, "float32", device=cuda) \
        == {"blocks_per_sm": res["blocks_per_sm"]}
    assert tuner.paged_blocks_per_sm(4, 32, 16, torch.float32,
                                     cuda) is None


def test_http_generate_over_a_paged_engine_counts_b4(cuda):
    """``/generate`` on the card, plain and streamed, over a graphed paged
    engine: both give the engine's own tokens, B4's launches are one a
    layer a decode step, and ``/statsz`` reports this process's count."""
    import json
    import threading
    import urllib.request
    from paddle_tpu_torch.serving.http import make_server
    model = GPTForCausalLM(GPTConfig(**MODEL), device=cuda, seed=0).eval()
    before = tpa.paged_attention.launches
    eng = LLMEngine(model, LLMEngineConfig(
        num_slots=4, max_seq=64, kv_layout="paged", page_size=16,
        paged_attn_impl="kernel", prefill_buckets=(8, 32)))
    httpd = make_server(None, port=0, llm_engine=eng)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    try:
        prompt = list(range(3, 23))
        want = eng.generate(prompt, max_new_tokens=12)["tokens"]
        plain = json.loads(post({"prompt": prompt, "max_new_tokens": 12}))
        lines = [json.loads(ln) for ln in post(
            {"prompt": prompt, "max_new_tokens": 12, "stream": True}
        ).splitlines() if ln]
        with urllib.request.urlopen(url.replace("/generate", "/statsz"),
                                    timeout=60) as r:
            reported = json.loads(r.read())["kernel_launches"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.drain(timeout=60)
    assert plain["tokens"] == want
    assert [ln["token"] for ln in lines[:-1]] == want
    steps = sum(eng.stats()["stats"].get(k, 0)
                for k in ("serving.llm.decode_ticks",
                          "serving.llm.warmup_decode_steps"))
    assert steps > 0
    assert tpa.paged_attention.launches - before == \
        MODEL["num_layers"] * steps
    assert reported["paged_attention"] == tpa.paged_attention.launches


# -- distributed training on the card (phase 34's contract at small sizes) --

@pytest.fixture
def nccl_world(cuda):
    """A world of one on NCCL in this process, taken down after (the
    port's default device restored)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core import device as core_device
    saved = core_device._CURRENT[0]
    dist.init_parallel_env()
    try:
        yield dist
    finally:
        dist.env.destroy_process_group()
        core_device._CURRENT[0] = saved


def test_nccl_world_of_one_collectives_are_the_identity(nccl_world):
    dist = nccl_world
    from paddle_tpu_torch.distributed import collective as C
    assert dist.env.backend() == "nccl"
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    want = x.clone()
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        assert torch.equal(dist.all_reduce(x, getattr(C.ReduceOp, op)), want)
    for got in (dist.broadcast(x, 0), dist.reduce(x, 0),
                dist.all_gather([], x)[0], dist.reduce_scatter(None, x),
                dist.alltoall(x), dist.p2p_exchange(x, 0, 0),
                dist.compressed_all_reduce(x), dist.scatter(x, [x], 0)):
        assert torch.equal(got, want)
    assert dist.all_gather_object([], 5) == [5]
    dist.barrier()


def test_graphed_data_parallel_step_is_bitwise_the_plain_step(nccl_world):
    dist = nccl_world
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (4, 32)), device="cuda")
    losses, lanes, launches = [], [], []
    for parallel in (True, False):
        net = GPTForCausalLM(GPTConfig(**MODEL, attn_impl="flash"),
                             device="cuda", seed=0)
        if parallel:
            dist.set_mesh(dist.build_mesh({"dp": 1}))
            net = dist.DataParallel(net)
        opt = AdamW(learning_rate=1e-3, parameters=net.parameters(),
                    device="cuda")
        m = Model(net, device="cuda")
        m.prepare(opt, GPTPretrainingCriterion())
        before = tfa.flash_attention_fwd.launches
        losses.append([m.train_batch([ids], [ids])[0] for _ in range(3)])
        launches.append(tfa.flash_attention_fwd.launches - before)
        lanes.append(m.lane)
        dist.set_mesh(None)
    assert lanes == ["graphed", "graphed"]
    assert losses[0] == losses[1]
    assert launches == [3 * MODEL["num_layers"]] * 2


@pytest.mark.parametrize("shape", [(1, 128, 4, 64), (1, 8192, 16, 128)],
                         ids=["s128_d64", "ring_chunk_d128"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_chunk_contract_on_b1_b3(cuda, causal, shape):
    """The ring's chunk contract: B1 returns the row LSE; B2 and B3 take
    a global LSE merged from another chunk and a delta computed outside,
    and write float32 gradients for bfloat16 inputs; all within bf16
    tolerance of the plain versions on the same inputs. The second shape
    is a chunk of chip_smoke's sp4 ring at GPT-3 1.3B's width (S 32768
    over four ranks, 16 heads of 128)."""
    rng = np.random.default_rng(7)
    b, s, h, d = shape

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)
                               * 0.5, device="cuda").to(torch.bfloat16)
    q, k0, v0, k1, v1, do = (t(b, s, h, d) for _ in range(6))
    o0, lse0 = tfa.flash_attention_fwd(q, k0, v0, causal)
    o1, lse1 = tfa.flash_attention_fwd(q, k1, v1, False)
    po0, plse0 = tfa.flash_attention_fwd_plain(q, k0, v0, causal)
    assert float((lse0 - plse0).abs().max()) < 2e-3
    assert float((o0.float() - po0.float()).abs().max()) < 2e-2
    lse = torch.logaddexp(lse0, lse1)           # the merged, global rows
    w0 = torch.exp(lse0 - lse).transpose(1, 2)[..., None]
    w1 = torch.exp(lse1 - lse).transpose(1, 2)[..., None]
    o = (o0.float() * w0 + o1.float() * w1).to(torch.bfloat16)
    delta = tfa.attention_delta(o, do)
    f32 = torch.float32
    dq = tfa.flash_attention_bwd_dq(q, k0, v0, do, lse, delta, causal,
                                    None, f32)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k0, v0, do, lse, delta, causal,
                                         None, f32, f32)
    pdq = tfa.flash_attention_bwd_dq_plain(q, k0, v0, do, lse, delta,
                                           causal, None, f32)
    pdk, pdv = tfa.flash_attention_bwd_dkv_plain(q, k0, v0, do, lse, delta,
                                                 causal, None, f32, f32)
    for got, ref in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.dtype == f32
        assert float((got - ref).abs().max()) <= \
            2e-2 * float(ref.abs().max()) + 1e-6
