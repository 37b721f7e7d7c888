"""Why the flash kernels run fp32 as 3xTF32, and why their fp32 bar is
2e-5.

The kernels B1, B2 and B3 (``paddle_tpu_torch/csrc/flash_mma.cuh``) take
fp32 products on the tensor cores: each operand x is split into big = x
rounded to TF32 and small = x - big rounded to TF32, and a product is
small*big + big*small + big*big in f32. This file applies that split, and
a single TF32 product for contrast, to B1's online-softmax forward and to
B2's and B3's formulas on the CPU and holds both to the same formulas in
float64: 3xTF32 stays within 2e-5 (max |err| / max |ref|, per output),
one TF32 product does not. No card and no jax needed.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BAR = 2e-5


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by clearing the 13 low mantissa bits, as a TF32 MMA
    reads an f32 operand."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 rounded to nearest, ties away from zero, as the
    kernels' split rounds (add half of the 13 dropped bits, then clear
    them)."""
    return ((x.contiguous().view(torch.int32) + 4096) & -8192).view(
        torch.float32)


def mm_3xtf32(a, b):
    """The kernels' 3xTF32: big = round(x), small = round(x - big)."""
    ab, bb = tf32_round(a), tf32_round(b)
    a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def mm_1xtf32(a, b):
    return tf32_trunc(a) @ tf32_trunc(b)


def backward(mm, q, k, v, do, lse, delta, causal, scale):
    """B2's and B3's formulas over [B, H, S, D] inputs with the product
    ``mm``: P = exp(S*scale - lse) masked to 0, dS = P (dO V^T - delta),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO."""
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        sq, skv = s.shape[-2:]
        mask = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        p = torch.where(mask, p, torch.zeros_like(p))
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do))


def forward(mm, q, k, v, causal, scale, bk=32):
    """B1's forward over [B, H, S, D] f32 inputs with the product ``mm``,
    tile by tile as the kernel takes it: Q scaled in f32 before the
    product; keys in tiles of ``bk`` (one warp's share of a tile); per
    tile the running max m and sum l move, the tile's P V is summed from
    zero and added to the rescaled output in f32; O = acc / max(l, 1e-30)
    and LSE = m + log(max(l, 1e-30)); masked scores -1e30, masked
    probabilities 0."""
    qs = q * scale
    sq, skv = q.shape[-2], k.shape[-2]
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros_like(q)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        s = mm(qs, k[..., k0:k0 + bk, :].transpose(-1, -2))
        ok = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            ok = rows >= torch.arange(k0, k0 + s.shape[-1])[None, :]
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm(p, v[..., k0:k0 + bk, :])
        m = m_new
    den = l.clamp_min(1e-30)
    return acc / den[..., None], m + torch.log(den)


def case(s_len, d, causal, seed):
    """f32 inputs [B=2, H=2, S, D] from a numpy seed, with lse and delta
    from the float64 forward, rounded to f32 as the kernels receive them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, s_len, d),
                                                        dtype=np.float32))
                   for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if causal:
        mask = torch.arange(s_len)[:, None] >= torch.arange(s_len)[None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    lse = torch.logsumexp(s, -1)
    out = torch.softmax(s, -1) @ v.double()
    delta = (do.double() * out).sum(-1)
    return q, k, v, do, lse, delta, scale


def rel_errs(got, ref):
    return [float((g.double() - r).abs().max() / r.abs().max())
            for g, r in zip(got, ref)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s_len", [17, 64, 100])
def test_3xtf32_meets_the_fp32_bar_and_1xtf32_does_not(s_len, d, causal):
    q, k, v, do, lse, delta, scale = case(s_len, d, causal,
                                          seed=s_len + d + causal)
    ref = backward(torch.matmul, q.double(), k.double(), v.double(),
                   do.double(), lse, delta, causal, scale)
    f32 = (q, k, v, do, lse.float(), delta.float(), causal, scale)
    three = rel_errs(backward(mm_3xtf32, *f32), ref)
    one = rel_errs(backward(mm_1xtf32, *f32), ref)
    assert max(three) <= BAR, three
    assert min(one) > BAR, one


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s_len", [64, 100])
def test_forward_3xtf32_meets_the_fp32_bar_and_1xtf32_does_not(s_len, d,
                                                               causal):
    """B1: O and LSE of the tiled online softmax under 3xTF32 stay within
    2e-5 of softmax attention in float64;
    under one TF32 product they miss it."""
    q, k, v, _, lse, _, scale = case(s_len, d, causal,
                                     seed=s_len + d + causal)
    s = (q.double() * scale) @ k.double().transpose(-1, -2)
    if causal:
        mask = torch.arange(s_len)[:, None] >= torch.arange(s_len)[None, :]
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    ref = (torch.softmax(s, -1) @ v.double(), lse)
    three = rel_errs(forward(mm_3xtf32, q, k, v, causal, scale), ref)
    one = rel_errs(forward(mm_1xtf32, q, k, v, causal, scale), ref)
    assert max(three) <= BAR, three
    assert min(one) > BAR, one


def test_tf32_truncation_clears_the_low_bits_toward_zero():
    """The kernels' split: big keeps the top 10 mantissa bits (toward zero, both
    signs), small = x - big is exact, and big + trunc(small) is within
    2^-20 of x."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    big = tf32_trunc(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert (big.abs() <= x.abs()).all() and torch.equal(big.sign(), x.sign())
    small = x - big
    assert torch.equal((big.double() + small.double()).float(), x)
    err = (big + tf32_trunc(small) - x).abs() / x.abs()
    assert float(err.max()) < 2.0 ** -20


def test_tf32_rounding_split_misses_under_2_22():
    """The kernels' split: big and small are whole TF32 values (the MMA
    reads them without loss), big is x rounded to nearest (within 2^-11
    of it), and big + small is within 2^-22 of x, on either side."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    big = tf32_round(x)
    small = tf32_round(x - big)
    for t in (big, small):
        assert (t.view(torch.int32) & 0x1FFF == 0).all()
    assert float(((big - x).abs() / x.abs()).max()) <= 2.0 ** -11
    err = (big.double() + small.double() - x.double()) / x.double().abs()
    assert float(err.abs().max()) < 2.0 ** -22
    assert float(err.min()) < 0 < float(err.max())
