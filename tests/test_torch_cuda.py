"""The port's CUDA kernels on the card: each kernel against its plain
version, the wrappers' refusals (no fallback on a CUDA tensor), and the
GPT forward and paged engine through the kernels at a small size.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on a machine with a card but
without jax it runs on its own, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

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
                                   (2, 64, 200, 2, 32, False)])
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
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_kernel_matches_plain(cuda, dtype, tol, d):
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(7, d=d))
    q, ak, av = q.to(dtype), ak.to(dtype), av.to(dtype)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt, pos)
    ref = tpa.paged_attention_plain(q, ak[:, 1], av[:, 1], bt, pos)
    assert tpa.paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    q, ak, av, bt, pos = (torch.from_numpy(x).to(cuda)
                          for x in _paged_case(8))
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(q, ak[:, 0], av[:, 0], bt.long(), pos)
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), ak[:, 0].half(), av[:, 0].half(), bt,
                            pos)


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
