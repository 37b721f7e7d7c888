"""B4's split of a sequence into chunks and their merge, on the CPU.

The paged decode kernel (``paddle_tpu_torch/csrc/paged_attention.cu``)
cuts each sequence's visible rows into chunks of ``chunk_pages_for``
pages, computes each chunk's softmax state (m, l, acc) apart, and merges
the chunks in chunk order: M = max m, L = sum l*exp(m - M), O = sum
acc*exp(m - M) / max(L, 1e-30). This file writes that rule in torch and
holds it to the plain version, ``paged_attention_plain``, at 1e-6: chunk
sizes from one page to the whole table, trash pages, a sequence at
position 0, one past its table and one that sees no row, and chunks whose
state is empty (m = -1e30, l = 0). No card and no jax needed.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

NEG = -1e30


def _case(seed, s_n=5, h=3, d=32, page=4, pps=10):
    """A 2-layer arena (layer 1 is a strided view), block tables mixing
    real pages and the trash page P, positions at -1 (no row visible), 0,
    a page edge, mid-table and past the table."""
    rng = np.random.default_rng(seed)
    n_pages = s_n * pps
    shape = (n_pages + 1, 2, page, h, d)
    ak = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    av = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    bt = rng.permutation(n_pages).reshape(s_n, pps).astype(np.int32)
    bt[rng.random((s_n, pps)) < 0.25] = n_pages
    pos = np.array([-1, 0, page - 1, pps * page // 2 + 1, pps * page + 5],
                   np.int32)[:s_n]
    q = torch.from_numpy(rng.standard_normal((s_n, h, d), dtype=np.float32))
    return q, ak[:, 1], av[:, 1], torch.from_numpy(bt), torch.from_numpy(pos)


def chunk_state(q, ka, va, bt, n_rows, s, c, chunk_pages, scale):
    """One block's state for chunk c of sequence s, per head: m [H],
    l [H], acc [H, D] over the chunk's visible rows whose page lies in
    the arena (entries outside it are masked, never read)."""
    page = ka.shape[1]
    h, d = q.shape[1:]
    r0 = c * chunk_pages * page
    r1 = min(n_rows, r0 + chunk_pages * page)
    m, l = torch.full((h,), NEG), torch.zeros(h)
    acc = torch.zeros(h, d)
    rows = [j for j in range(r0, r1)
            if 0 <= int(bt[s, j // page]) < ka.shape[0]]
    if not rows:
        return m, l, acc
    pid = torch.tensor([int(bt[s, j // page]) for j in rows])
    off = torch.tensor([j % page for j in rows])
    k, v = ka[pid, off], va[pid, off]                   # [n, H, D]
    sc = torch.einsum("hd,nhd->hn", q[s] * scale, k)
    m = sc.amax(-1)
    p = torch.exp(sc - m[:, None])
    return m, p.sum(-1), torch.einsum("hn,nhd->hd", p, v)


def merge(states):
    """The chunks' states merged in chunk order: (M, L, A)."""
    big_m = torch.stack([m for m, _, _ in states]).amax(0)
    big_l, big_a = torch.zeros_like(big_m), None
    for m, l, a in states:
        f = torch.exp(m - big_m)
        big_l = big_l + l * f
        big_a = a * f[:, None] if big_a is None else big_a + a * f[:, None]
    return big_m, big_l, big_a


def chunked_paged_attention(q, ka, va, bt, pos, chunk_pages, scale=None):
    """B4's rule: every sequence's visible rows in chunks of chunk_pages
    pages (at least one chunk, which writes 0 when no row is visible),
    merged in chunk order."""
    s_n, h, d = q.shape
    sc = scale if scale is not None else 1.0 / np.sqrt(d)
    pps, page = bt.shape[1], ka.shape[1]
    rows_per_chunk = chunk_pages * page
    out = torch.empty_like(q)
    for s in range(s_n):
        n_rows = min(int(pos[s]) + 1, pps * page)
        n_chunks = max(1, -(-n_rows // rows_per_chunk))
        states = [chunk_state(q, ka, va, bt, n_rows, s, c, chunk_pages, sc)
                  for c in range(n_chunks)]
        _, big_l, big_a = merge(states)
        out[s] = big_a / big_l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("chunk_pages", [1, 2, 3, 4, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_and_merge_equals_plain(seed, chunk_pages):
    q, ka, va, bt, pos = _case(seed)
    assert not ka.is_contiguous()
    got = chunked_paged_attention(q, ka, va, bt, pos, chunk_pages)
    want = tpa.paged_attention_plain(q, ka, va, bt, pos)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # no row visible


def test_chunk_and_merge_at_d128_with_explicit_scale():
    q, ka, va, bt, pos = _case(2, s_n=4, h=2, d=128, page=16, pps=6)
    got = chunked_paged_attention(q, ka, va, bt, pos, 2, scale=0.2)
    want = tpa.paged_attention_plain(q, ka, va, bt, pos, scale=0.2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_empty_chunks_merge_without_nan():
    """A chunk that saw no row has m = -1e30 and l = 0: beside a real
    chunk it weighs exp(-1e30 - M) = 0, and alone it gives exactly 0."""
    h, d = 2, 8
    empty = (torch.full((h,), NEG), torch.zeros(h), torch.zeros(h, d))
    real = (torch.tensor([0.5, -2.0]), torch.tensor([3.0, 1.5]),
            torch.arange(h * d, dtype=torch.float32).reshape(h, d))
    for states in ([empty, real], [real, empty], [empty, real, empty]):
        m, l, a = merge(states)
        assert torch.equal(m, real[0]) and torch.equal(l, real[1])
        assert torch.equal(a, real[2])
    m, l, a = merge([empty, empty])
    out = a / l.clamp_min(1e-30)[:, None]
    assert torch.equal(out, torch.zeros(h, d))


def test_masked_pages_give_an_empty_chunk():
    """Block-table entries outside the arena are masked, never read: a
    sequence whose pages all lie outside sees no row and gets 0."""
    q, ka, va, bt, pos = _case(3)
    bt[2] = -1
    bt[3, :] = ka.shape[0]
    got = chunked_paged_attention(q, ka, va, bt, pos, 2)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    keep = [1, 4]
    want = tpa.paged_attention_plain(q[keep], ka, va, bt[keep], pos[keep])
    torch.testing.assert_close(got[keep], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pps,seq_heads,n_sms,want", [
    (64, 128, 132, 8),      # chip_smoke's case: 8 chunks of 8 pages
    (64, 8 * 32, 132, 13),  # more sequence-heads: 5 chunks
    (256, 4, 132, 1),       # a few long sequences: one page a chunk
    (3, 1, 132, 1),         # never more chunks than pages
    (5000, 1, 132, 5),      # 1000 chunks of 5 pages
    (4096, 4096, 132, 1024)])  # capped at MAX_CHUNK_PAGES: 4 chunks
def test_chunk_rule(pps, seq_heads, n_sms, want):
    cp = tpa.chunk_pages_for(pps, seq_heads, n_sms)
    assert cp == want
    assert 1 <= cp <= tpa.MAX_CHUNK_PAGES
    chunks = -(-pps // cp)
    assert (chunks - 1) * cp < pps <= chunks * cp
