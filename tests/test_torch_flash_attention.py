"""Flash attention forward (B1): the port's plain version against the JAX
package's Pallas kernel run in interpret mode, and the wrapper's contract
on the CPU. The CUDA kernel is held against its plain version in
``test_torch_cuda.py``."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.ops import pallas_attention as jfa  # noqa: E402
tfa = importlib.import_module(  # noqa: E402
    "paddle_tpu_torch.ops.flash_attention")


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


def _jax_flash(q, k, v, causal, dtype=jnp.float32):
    out, _ = jfa.flash_attention(Tensor(jnp.asarray(q, dtype)),
                                 Tensor(jnp.asarray(k, dtype)),
                                 Tensor(jnp.asarray(v, dtype)),
                                 causal=causal)
    return np.asarray(out._data.astype(jnp.float32))


CASES = [
    # (b, sq, skv, h, d, causal)
    (2, 64, 64, 2, 32, True),
    (2, 64, 64, 2, 32, False),
    (1, 100, 100, 2, 32, True),
    (1, 100, 100, 2, 32, False),
    (2, 48, 80, 2, 32, True),
    (2, 80, 48, 2, 32, True),
    (1, 40, 72, 2, 64, False),
]


def _numpy_f64(q, k, v, causal):
    """Attention in float64 NumPy: the judge when the two sides differ."""
    qf, kf, vf = (np.moveaxis(x.astype(np.float64), 2, 1) for x in (q, k, v))
    s = qf @ np.swapaxes(kf, -1, -2) / np.sqrt(q.shape[-1])
    if causal:
        sq, skv = s.shape[-2:]
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None, :], s,
                     -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.moveaxis(p @ vf / p.sum(-1, keepdims=True), 1, 2)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}_sq{}_skv{}_h{}_d{}_{}".format(
    *c[:5], "causal" if c[5] else "full"))
def test_plain_matches_jax_fp32(case):
    b, sq, skv, h, d, causal = case
    q, k, v = _inputs(0, b, sq, skv, h, d)
    ref = _jax_flash(q, k, v, causal)
    out, none = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    assert none is None
    # each side against float64 first, so a drift names the side
    exact = _numpy_f64(q, k, v, causal)
    np.testing.assert_allclose(ref, exact, rtol=1e-5, atol=1e-5,
                               err_msg="JAX Pallas side vs float64")
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-5, atol=1e-5,
                               err_msg="port plain side vs float64")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_bf16(causal):
    q, k, v = _inputs(1, 2, 64, 64, 2, 32)
    ref = _jax_flash(q, k, v, causal, dtype=jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, _ = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (48, 80)])
def test_out_and_lse_match_fa_fwd_with_lse(causal, sq, skv):
    b, h, d = 2, 2, 32
    q, k, v = _inputs(2, b, sq, skv, h, d)
    sc = 1.0 / np.sqrt(d)

    def to_bh(x):
        return jnp.asarray(np.moveaxis(x, 2, 1).reshape(b * h, x.shape[1], d))
    o_j, lse_j = jfa._fa_fwd_with_lse(to_bh(q), to_bh(k), to_bh(v), causal,
                                      sc, 16, 16, True, skv)
    o_j = np.moveaxis(np.asarray(o_j).reshape(b, h, sq, d), 1, 2)
    lse_j = np.asarray(lse_j).reshape(b, h, sq)
    out, lse = tfa.flash_attention_fwd(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, sq)
    np.testing.assert_allclose(out.numpy(), o_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=1e-5, atol=1e-5)


def test_explicit_scale_matches_jax():
    q, k, v = _inputs(3, 1, 32, 32, 2, 32)
    out_j, _ = jfa.flash_attention(Tensor(jnp.asarray(q)),
                                   Tensor(jnp.asarray(k)),
                                   Tensor(jnp.asarray(v)), causal=True,
                                   scale=0.3)
    out, _ = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j._data),
                               rtol=1e-5, atol=1e-5)


def test_rejects_dropout_and_return_softmax():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="dropout"):
        tfa.flash_attention(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match="return_softmax"):
        tfa.flash_attention(q, q, q, return_softmax=True)


def test_rejects_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, torch.zeros(1, 8, 1, 32), q)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q.double())


def test_cpu_tensors_take_plain_version_without_launching():
    before = tfa.flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 1, 16, 16, 1, 32))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert tfa.flash_attention_fwd.launches == before


def test_first_query_row_sees_only_first_key():
    """Causal, top-left aligned: query 0 attends key 0 alone, also when
    Sq < Skv, so its output is v[0] and its LSE is its one score."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 24, 2, 32))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=1e-6, atol=1e-6)
    s00 = (q[:, 0] * k[:, 0]).sum(-1) / np.sqrt(32)
    torch.testing.assert_close(lse[:, :, 0], s00, rtol=1e-5, atol=1e-5)

