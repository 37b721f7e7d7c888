"""Flash attention backward (B2 dQ, B3 dK/dV): the port's plain versions
against the JAX package's Pallas backward run in interpret mode, the
differentiable ``flash_attention`` against ``jax.grad``, a float64
gradcheck, and the wrappers' contract on the CPU. The CUDA kernels are
held against their plain versions in ``test_torch_cuda.py``."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops import pallas_attention as jfa  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
tfa = importlib.import_module(  # noqa: E402
    "paddle_tpu_torch.ops.flash_attention")

BLOCK = 16          # the Pallas blocks; sequences are padded to them


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, sq, h, d), dtype=np.float32))


def _to_bh(x, pad_to, dtype):
    """[B, S, H, D] -> the Pallas kernels' [B*H, S_pad, D], zero padded."""
    b, s, h, d = x.shape
    x = np.moveaxis(x, 2, 1).reshape(b * h, s, d)
    x = np.pad(x, ((0, 0), (0, pad_to - s), (0, 0)))
    return jnp.asarray(x, dtype)


def _from_bh(x, b, s, h):
    x = np.asarray(jnp.asarray(x, jnp.float32))
    return np.ascontiguousarray(np.moveaxis(x[:, :s].reshape(b, h, s, -1),
                                            1, 2))


def _pad_len(n):
    return -(-n // BLOCK) * BLOCK


def _jax_bwd(q, k, v, do, causal, dtype=jnp.float32, delta=None,
             grad_dtypes=None):
    """The JAX forward and backward kernels in interpret mode on padded
    copies; returns unpadded ``(out, lse, dq, dk, dv)`` as f32 numpy."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    sp, kp = _pad_len(sq), _pad_len(skv)
    sc = 1.0 / np.sqrt(d)
    qb, kb, vb, dob = (_to_bh(q, sp, dtype), _to_bh(k, kp, dtype),
                       _to_bh(v, kp, dtype), _to_bh(do, sp, dtype))
    out, lse = jfa._fa_fwd_with_lse(qb, kb, vb, causal, sc, BLOCK, BLOCK,
                                    True, skv)
    if delta is not None:
        delta = jnp.asarray(np.pad(delta.reshape(b * h, 1, sq),
                                   ((0, 0), (0, 0), (0, sp - sq))))
    dq, dk, dv = jfa._fa_bwd_with_lse(qb, kb, vb, dob, out, lse, causal, sc,
                                      BLOCK, BLOCK, True, skv, delta=delta,
                                      grad_dtypes=grad_dtypes)
    lse = np.array(lse)[:, 0, :sq].reshape(b, h, sq)
    return (_from_bh(out, b, sq, h), lse, _from_bh(dq, b, sq, h),
            _from_bh(dk, b, skv, h), _from_bh(dv, b, skv, h),
            [x.dtype for x in (dq, dk, dv)])


CASES = [
    # (b, sq, skv, h, d, causal)
    (2, 64, 64, 2, 32, True),
    (2, 64, 64, 2, 32, False),
    (1, 50, 50, 2, 32, True),           # odd length: compare unpadded
    (1, 37, 61, 2, 32, False),
    (2, 48, 80, 2, 32, True),           # Sq < Skv
    (2, 80, 48, 2, 32, True),           # Sq > Skv
    (1, 40, 72, 2, 64, False),
]


def _ids(c):
    return "b{}_sq{}_skv{}_h{}_d{}_{}".format(
        *c[:5], "causal" if c[5] else "full")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_pallas_fp32(case):
    b, sq, skv, h, d, causal = case
    q, k, v, do = _inputs(0, b, sq, skv, h, d)
    out, lse, dq, dk, dv, _ = _jax_bwd(q, k, v, do, causal)
    t = [torch.from_numpy(x) for x in (q, k, v, out, lse, do)]
    tq, tk, tv = tfa.flash_attention_bwd_plain(t[0], t[1], t[2], t[3], t[4],
                                               t[5], causal)
    for got, ref in ((tq, dq), (tk, dk), (tv, dv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_pallas_bf16(causal):
    q, k, v, do = _inputs(1, 2, 48, 64, 2, 32)
    out, lse, dq, dk, dv, _ = _jax_bwd(q, k, v, do, causal, jnp.bfloat16)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, out, do)]
    tq, tk, tv = tfa.flash_attention_bwd_plain(
        bf[0], bf[1], bf[2], bf[3], torch.from_numpy(lse), bf[4], causal)
    for got, ref in ((tq, dq), (tk, dk), (tv, dv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)


def test_given_delta_is_used_as_jax_uses_it():
    """A delta passed in (ring-flash precomputes it) replaces
    rowsum(dO*O); a deliberately shifted one must move both sides alike."""
    b, sq, skv, h, d = 2, 48, 48, 2, 32
    q, k, v, do = _inputs(2, b, sq, skv, h, d)
    delta = (np.random.default_rng(3).standard_normal((b, h, sq))
             .astype(np.float32))
    out, lse, dq, dk, dv, _ = _jax_bwd(q, k, v, do, True, delta=delta)
    t = [torch.from_numpy(x) for x in (q, k, v, out, lse, do)]
    tq, tk, tv = tfa.flash_attention_bwd_plain(
        *t, True, delta=torch.from_numpy(delta))
    for got, ref in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # and the wrappers' delta is rowsum(dO * O) when none is given
    np.testing.assert_allclose(
        tfa.attention_delta(t[3], t[5]).numpy(),
        np.moveaxis((do * out).sum(-1), 1, 2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_dt,grad_dt", [
    (jnp.float32, jnp.bfloat16), (jnp.bfloat16, jnp.float32)],
    ids=["f32_in_bf16_grads", "bf16_in_f32_grads"])
def test_grad_dtypes_match_jax(in_dt, grad_dt):
    q, k, v, do = _inputs(4, 1, 48, 48, 2, 32)
    out, lse, dq, dk, dv, dts = _jax_bwd(q, k, v, do, True, in_dt,
                                         grad_dtypes=(grad_dt,) * 3)
    assert all(dt == grad_dt for dt in dts)
    tin = torch.float32 if in_dt == jnp.float32 else torch.bfloat16
    tgrad = torch.float32 if grad_dt == jnp.float32 else torch.bfloat16
    t = [torch.from_numpy(x).to(tin) for x in (q, k, v, out, do)]
    tq, tk, tv = tfa.flash_attention_bwd_plain(
        t[0], t[1], t[2], t[3], torch.from_numpy(lse), t[4], True,
        grad_dtypes=(tgrad,) * 3)
    for got, ref in ((tq, dq), (tk, dk), (tv, dv)):
        assert got.dtype == tgrad
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                                   atol=2e-2)


def test_kernel_plain_versions_compose_the_backward():
    """B2's and B3's plain versions, given delta, are the whole plain
    backward split in two, in the requested output types."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 2, 40, 56, 2, 32))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    delta = tfa.attention_delta(out, do)
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    pq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    pk, pv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                         dv_dtype=torch.bfloat16)
    torch.testing.assert_close(pq, dq, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pk, dk, rtol=1e-6, atol=1e-6)
    assert pv.dtype == torch.bfloat16
    torch.testing.assert_close(pv, dv.to(torch.bfloat16))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(32, 32), (24, 40)])
def test_autograd_function_matches_jax_grad(causal, sq, skv):
    b, h, d = 2, 2, 32
    q, k, v, do = _inputs(6, b, sq, skv, h, d)

    def jloss(qq, kk, vv):
        out, _ = jfa.flash_attention(qq, kk, vv, causal=causal,
                                     block_q=BLOCK, block_k=BLOCK)
        out = getattr(out, "_data", out)
        return jnp.sum(out * jnp.asarray(do))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, none = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert none is None
    (out * torch.from_numpy(do)).sum().backward()
    for got, ref in ((tq.grad, refs[0]), (tk.grad, refs[1]),
                     (tv.grad, refs[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_float64(causal):
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(1, n, 2, 32, generator=gen, dtype=torch.float64,
                           requires_grad=True) for n in (12, 20, 20))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal)[0],
        (q, k, v))


def test_outputs_carry_grad_fn_and_needs_input_grad_is_respected():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(8, 1, 16, 16, 2, 32))
    q.requires_grad_()
    out, _ = tfa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert "FlashAttentionFunction" in type(out.grad_fn).__name__
    out.backward(do)
    assert q.grad is not None and k.grad is None and v.grad is None
    # the raw forward stays non-differentiable; no_grad builds no graph
    raw, _ = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert raw.grad_fn is None
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v)[0].grad_fn is None
    dq, dk, dv = tfa.flash_attention_bwd(
        q.detach(), k, v, out.detach(), tfa.flash_attention_fwd(q, k, v,
                                                                True)[1],
        do, True, needs_input_grad=(False, True, False))
    assert dq is None and dv is None and dk.shape == k.shape


def test_cpu_backward_launches_no_kernel():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, 1, 16, 16, 2, 32))
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    q.requires_grad_()
    tfa.flash_attention(q, k, v, causal=True)[0].backward(do)
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == before


def test_backward_rejects_mismatched_inputs():
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_bwd_dq(q, q, q, q.double(), lse, lse)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse.double(), lse)
    with pytest.raises(ValueError, match="delta"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, torch.zeros(1, 2, 9))


def test_gpt_flash_gradients_match_dense():
    """The flash branch of MultiHeadAttention is trainable: a GPT's
    gradients through flash equal those through dense attention, the
    attention projections included."""
    cfg = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=24, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 24)))
    grads = {}
    for impl in ("flash", "dense"):
        m = GPTForCausalLM(GPTConfig(**cfg, attn_impl=impl), device="cpu",
                           seed=3)
        m(ids).logsumexp(-1).mean().backward()
        grads[impl] = {n: p.grad for n, p in m.named_parameters()}
    for n, g in grads["dense"].items():
        assert grads["flash"][n] is not None, n
        torch.testing.assert_close(grads["flash"][n], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()) + 1e-7)
