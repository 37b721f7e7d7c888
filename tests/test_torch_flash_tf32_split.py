"""Why the flash backward kernels run fp32 as 3xTF32, and why their fp32
bar is 2e-5.

The kernels B2 and B3 (``paddle_tpu_torch/csrc/flash_bwd_mma.cuh``) take
fp32 products on the tensor cores: each operand x is split into
big = tf32(x) and small = tf32(x - big), rounded as ``cvt.rna.tf32.f32``
does (to nearest on 10 mantissa bits, ties away from zero), and a product
is small*big + big*small + big*big in f32. This file applies that split,
and a single TF32 product for contrast, to B2's and B3's formulas on the
CPU and holds both to the same formulas in float64: 3xTF32 stays within
2e-5 (max |err| / max |ref|, per gradient), one TF32 product does not.
No card and no jax needed.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BAR = 2e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude's bit pattern and clear them."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32)


def mm_3xtf32(a, b):
    ab, bb = tf32_rna(a), tf32_rna(b)
    a_s, b_s = tf32_rna(a - ab), tf32_rna(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def mm_1xtf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


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
@pytest.mark.parametrize("s_len", [64, 100])
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


def test_tf32_rounding_is_nearest_ties_away():
    """The helper rounds as cvt.rna: 10 mantissa bits, ties away from
    zero, both signs."""
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing just above 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp * 0.49,
                      one + ulp * 1.5, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    r = tf32_rna(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
