"""Paged decode attention (B4): the port's plain version against the JAX
package's Pallas kernel in interpret mode, the page pool and the in-place
arena writers. The CUDA kernel is held against its plain version in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.paged_attention import \
    paged_attention as jax_paged_attention  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.serving.llm.paged import (PagePool,  # noqa: E402
                                                PagedKVCache,
                                                PagesExhausted,
                                                paged_gather_rows,
                                                paged_write_prompt_rows,
                                                paged_write_rows,
                                                pages_for_tokens)


def _case(seed, s_n=4, h=4, d=32, page=4, pps=6, layers=2):
    """A multi-layer arena (so the layer view is strided), block tables
    that mix real pages and the trash page, and positions at 0, on page
    edges and past the table."""
    rng = np.random.default_rng(seed)
    n_pages = s_n * pps
    arena_k = rng.standard_normal((n_pages + 1, layers, page, h, d),
                                  dtype=np.float32)
    arena_v = rng.standard_normal((n_pages + 1, layers, page, h, d),
                                  dtype=np.float32)
    bt = rng.permutation(n_pages).reshape(s_n, pps).astype(np.int32)
    bt[rng.random((s_n, pps)) < 0.25] = n_pages          # trash entries
    positions = np.array([0, page - 1, page, pps * page + 3][:s_n],
                         np.int32)
    q = rng.standard_normal((s_n, h, d), dtype=np.float32)
    return q, arena_k, arena_v, bt, positions


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_jax_interpret(seed, layer):
    q, ak, av, bt, pos = _case(seed)
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(ak[:, layer]),
                              jnp.asarray(av[:, layer]), jnp.asarray(bt),
                              jnp.asarray(pos), interpret=True)
    tk, tv = torch.from_numpy(ak), torch.from_numpy(av)
    kb, vb = tk[:, layer], tv[:, layer]
    assert not kb.is_contiguous()                       # a strided view
    out = tpa.paged_attention(torch.from_numpy(q), kb, vb,
                              torch.from_numpy(bt), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_jax_explicit_scale_and_d64():
    q, ak, av, bt, pos = _case(3, s_n=3, h=2, d=64, page=8, pps=3)
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(ak[:, 0]),
                              jnp.asarray(av[:, 0]), jnp.asarray(bt),
                              jnp.asarray(pos), scale=0.2, interpret=True)
    out = tpa.paged_attention(torch.from_numpy(q),
                              torch.from_numpy(ak)[:, 0],
                              torch.from_numpy(av)[:, 0],
                              torch.from_numpy(bt), torch.from_numpy(pos),
                              scale=0.2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,d", [("float16", 32), ("float16", 100),
                                     ("bfloat16", 100), ("float32", 7)])
def test_plain_matches_jax_interpret_in_every_type_and_head_dim(dtype, d):
    """The types and head dims the CUDA kernel takes since it serves every
    model (float16, rows that are not whole 16-byte vectors): the plain
    version against the Pallas kernel in interpret mode on the same
    half-precision inputs, both accumulating in float32 and rounding once
    to the input type (one rounding step of it)."""
    q, ak, av, bt, pos = _case(5, d=d)
    q, ak, av = (x.astype(dtype if dtype != "bfloat16" else np.float32)
                 for x in (q, ak, av))
    jd = getattr(jnp, dtype)
    ref = jax_paged_attention(jnp.asarray(q, jd), jnp.asarray(ak[:, 1], jd),
                              jnp.asarray(av[:, 1], jd), jnp.asarray(bt),
                              jnp.asarray(pos), interpret=True)
    td = getattr(torch, dtype)
    out = tpa.paged_attention(torch.from_numpy(q).to(td),
                              torch.from_numpy(ak).to(td)[:, 1],
                              torch.from_numpy(av).to(td)[:, 1],
                              torch.from_numpy(bt), torch.from_numpy(pos))
    assert out.dtype == td
    tol = {"float16": 1e-3, "bfloat16": 8e-3, "float32": 1e-5}[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_position_zero_attends_first_row_only():
    q, ak, av, bt, pos = _case(4)
    bt[0, 0] = 5
    pos[0] = 0
    out = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(ak)[:, 0],
                              torch.from_numpy(av)[:, 0],
                              torch.from_numpy(bt), torch.from_numpy(pos))
    np.testing.assert_allclose(out[0].numpy(), av[5, 0, 0], rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_take_plain_version_without_launching():
    q, ak, av, bt, pos = (torch.from_numpy(x) for x in _case(5))
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, ak[:, 1], av[:, 1], bt, pos)
    ref = tpa.paged_attention_plain(q, ak[:, 1], av[:, 1], bt, pos)
    assert torch.equal(out, ref)
    assert tpa.paged_attention.launches == before


def test_rejects_bad_shapes():
    q, ak, av, bt, pos = (torch.from_numpy(x) for x in _case(6))
    with pytest.raises(ValueError):
        tpa.paged_attention(q[:, :2], ak[:, 0], av[:, 0], bt, pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, ak[:, 0], av[:, 0], bt[:2], pos)


def test_page_pool_refcounts_and_double_free():
    pool = PagePool(3)
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.free_pages == 1
    pool.retain(a)
    assert pool.release(a) is False and pool.release(a) is True
    with pytest.raises(ValueError, match="double-free"):
        pool.release(a)
    with pytest.raises(PagesExhausted):
        pool.alloc_many(3)
    assert pool.free_pages == 2          # the failed claim took nothing
    assert pages_for_tokens(9, 4) == 3 and pages_for_tokens(8, 4) == 2


def test_kv_cache_maps_pages_and_frees_to_trash():
    kv = PagedKVCache(2, 2, 16, 2, 8, page_size=4, num_pages=6,
                      device="cpu")
    slot = kv.alloc()
    assert kv.ensure_pages(slot, 5) == 2
    assert kv.block_tables[slot].tolist() == [0, 1, 6, 6]
    with pytest.raises(PagesExhausted):
        kv.ensure_pages(kv.alloc(), 16 + 4)
    kv.free(slot)
    assert kv.block_tables[slot].tolist() == [6, 6, 6, 6]
    assert kv.pool.free_pages == 6
    with pytest.raises(ValueError, match="double free"):
        kv.free(slot)


def test_writers_are_in_place_and_gather_reads_back():
    kv = PagedKVCache(1, 2, 8, 2, 4, page_size=4, num_pages=3,
                      device="cpu")
    slot = kv.alloc()
    kv.ensure_pages(slot, 8)
    k_ptr = kv.k.data_ptr()
    rows = torch.arange(8 * 2 * 2 * 4, dtype=torch.float32).reshape(8, 2,
                                                                     2, 4)
    pos = torch.arange(8)
    pid = kv.block_tables[slot].long()[pos // 4]
    paged_write_prompt_rows(kv.k, rows, pid, pos % 4)
    assert kv.k.data_ptr() == k_ptr
    for layer in range(2):
        got = paged_gather_rows(kv.k[:, layer], kv.block_tables[:1])
        torch.testing.assert_close(got[0], rows[:, layer])
    new = torch.full((1, 2, 4), -1.0)
    paged_write_rows(kv.k[:, 1], new, pid[5:6], torch.tensor([1]))
    assert torch.equal(kv.k[pid[5], 1, 1], new[0])
    assert torch.equal(kv.k[pid[5], 0, 1], rows[5, 0])

