"""The port's concat cache and encoder-decoder layers against the JAX
package (``nn/transformer.py``): ``MultiHeadAttention`` with a ``Cache``
(one token at a time) and a ``StaticCache`` (cross-attention),
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``,
their ``gen_cache`` and the GPT's incremental forward, all at 1e-5 on the
same numpy inputs and weights. The JAX package's decoder layer returns
the incremental cache alone, so its cache cannot be fed back for a
second step; the port returns ``(incremental, static)`` as Paddle does,
and the multi-step tests hold the port against its own full forward."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io, nn  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.nn import transformer as ttr  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
E, H, FF = 64, 2, 128          # head dim 32: the flash route takes it


def _arrays(jlayer):
    return {k: np.asarray(v._data) for k, v in jlayer.state_dict().items()}


def _carry(jlayer, player):
    """Load the JAX layer's weights into the port's, names 1:1."""
    player.load_state_dict(framework_io.state_dict_from_reference(
        _arrays(jlayer), "cpu"), strict=True)
    return player.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _j(a):
    return Tensor(jnp.asarray(a))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t._data)


def _mha_pair(seed=0, need_weights=False):
    paddle.seed(seed)
    jm = jnn.MultiHeadAttention(E, H, need_weights=need_weights)
    jm.eval()
    pm = _carry(jm, nn.MultiHeadAttention(E, H, need_weights=need_weights,
                                          device="cpu"))
    return jm, pm


def test_incremental_cache_matches_full_causal_and_jax():
    """Feed 6 tokens one at a time through a ``Cache``: each step's output
    equals row t of the full causal forward (port) and the JAX package's
    step, and the grown cache equals the JAX package's."""
    jm, pm = _mha_pair()
    x = _x(1, 2, 6, E)
    with torch.no_grad():
        full = pm(torch.from_numpy(x), attn_mask=nn.CAUSAL_MASK)
    pc = pm.gen_cache(torch.from_numpy(x))
    jc = jm.gen_cache(_j(x))
    assert tuple(pc.k.shape) == (2, H, 0, E // H)
    for t in range(6):
        xt = x[:, t:t + 1]
        with torch.no_grad():
            out, pc = pm(torch.from_numpy(xt), attn_mask=nn.CAUSAL_MASK,
                         cache=pc)
        jout, jc = jm(_j(xt), attn_mask=jnn.CAUSAL_MASK, cache=jc)
        assert isinstance(pc, nn.MultiHeadAttention.Cache)
        assert tuple(pc.k.shape) == (2, H, t + 1, E // H)
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        np.testing.assert_allclose(_np(out)[:, 0], _np(full)[:, t], **TOL)
        np.testing.assert_allclose(_np(pc.k), _np(jc.k), **TOL)
        np.testing.assert_allclose(_np(pc.v), _np(jc.v), **TOL)


def test_prefix_then_tokens_offsets_the_causal_mask():
    """A 4-token block on a 3-row cache: the triu shifts by the cached
    prefix (offset lk - lq + 1), as in the JAX package."""
    jm, pm = _mha_pair(seed=2)
    x = _x(3, 1, 7, E)
    pc = pm.gen_cache(torch.from_numpy(x))
    jc = jm.gen_cache(_j(x))
    with torch.no_grad():
        _, pc = pm(torch.from_numpy(x[:, :3]), attn_mask=nn.CAUSAL_MASK,
                   cache=pc)
        out, _ = pm(torch.from_numpy(x[:, 3:]), attn_mask=nn.CAUSAL_MASK,
                    cache=pc)
        full = pm(torch.from_numpy(x), attn_mask=nn.CAUSAL_MASK)
    _, jc = jm(_j(x[:, :3]), attn_mask=jnn.CAUSAL_MASK, cache=jc)
    jout, _ = jm(_j(x[:, 3:]), attn_mask=jnn.CAUSAL_MASK, cache=jc)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(out), _np(full)[:, 3:], **TOL)


def test_static_cache_cross_attention_matches_jax():
    jm, pm = _mha_pair(seed=4)
    q, mem = _x(5, 2, 3, E), _x(6, 2, 9, E)
    for cache_type in (None, "type"):
        if cache_type is None:
            pc = pm.compute_kv(torch.from_numpy(mem), torch.from_numpy(mem))
            jc = jm.compute_kv(_j(mem), _j(mem))
        else:
            pc = pm.gen_cache(torch.from_numpy(mem),
                              type=nn.MultiHeadAttention.StaticCache)
            jc = jm.gen_cache(_j(mem), type=jnn.MultiHeadAttention.StaticCache)
        assert isinstance(pc, nn.MultiHeadAttention.StaticCache)
        with torch.no_grad():
            out = pm(torch.from_numpy(q), torch.from_numpy(mem),
                     torch.from_numpy(mem), cache=pc)
            plain = pm(torch.from_numpy(q), torch.from_numpy(mem))
        assert isinstance(out, torch.Tensor)   # no cache returned
        jout = jm(_j(q), _j(mem), _j(mem), cache=jc)
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        np.testing.assert_allclose(_np(out), _np(plain), **TOL)


def test_need_weights_with_cache_returns_out_weights_cache():
    jm, pm = _mha_pair(seed=7, need_weights=True)
    x = _x(8, 2, 4, E)
    pc = pm.gen_cache(torch.from_numpy(x))
    jc = jm.gen_cache(_j(x))
    with torch.no_grad():
        pres = pm(torch.from_numpy(x), attn_mask=nn.CAUSAL_MASK, cache=pc)
    jres = jm(_j(x), attn_mask=jnn.CAUSAL_MASK, cache=jc)
    assert len(pres) == len(jres) == 3
    for a, b in zip(pres[:2], jres[:2]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(pres[2].k), _np(jres[2].k), **TOL)


def test_no_flash_call_when_a_cache_is_given(monkeypatch):
    """A call with a cache is never flash-eligible; the same call without
    one takes the flash route (``attn_impl="flash"``)."""
    calls = []
    real = ttr.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttr, "flash_attention", spy)
    pm = nn.MultiHeadAttention(E, H, attn_impl="flash", device="cpu").eval()
    x = torch.from_numpy(_x(9, 1, 5, E))
    with torch.no_grad():
        pm(x, attn_mask=nn.CAUSAL_MASK, cache=pm.gen_cache(x))
        pm(x, x, x, cache=pm.gen_cache(
            x, type=nn.MultiHeadAttention.StaticCache))
        assert calls == []
        pm(x, attn_mask=nn.CAUSAL_MASK)
    assert calls == [1]


def _decoder_layer_pair(normalize_before, seed=10):
    paddle.seed(seed)
    jl = jnn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                     activation="relu",
                                     normalize_before=normalize_before)
    jl.eval()
    pl = _carry(jl, nn.TransformerDecoderLayer(
        E, H, FF, dropout=0.0, activation="relu",
        normalize_before=normalize_before, device="cpu"))
    return jl, pl


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_forward_matches_jax(normalize_before):
    jl, pl = _decoder_layer_pair(normalize_before)
    tgt, mem = _x(11, 2, 5, E), _x(12, 2, 7, E)
    mask = np.triu(np.full((5, 5), -1e9, np.float32), 1)
    with torch.no_grad():
        out = pl(torch.from_numpy(tgt), torch.from_numpy(mem),
                 torch.from_numpy(mask))
    jout = jl(_j(tgt), _j(mem), _j(mask))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_first_cached_step_matches_jax(normalize_before):
    """One step with ``gen_cache``: same output and incremental cache as
    the JAX package; the port also hands back the static cache."""
    jl, pl = _decoder_layer_pair(normalize_before, seed=13)
    tgt, mem = _x(14, 2, 1, E), _x(15, 2, 7, E)
    pcache = pl.gen_cache(torch.from_numpy(mem))
    jcache = jl.gen_cache(_j(mem))
    with torch.no_grad():
        out, (inc, static) = pl(torch.from_numpy(tgt),
                                torch.from_numpy(mem), nn.CAUSAL_MASK,
                                None, pcache)
    jout, jnew = jl(_j(tgt), _j(mem), jnn.CAUSAL_MASK, None, jcache)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(inc.k), _np(jnew[0].k), **TOL)
    assert static is pcache[1]


def _decoder_pair(seed=16, layers=2):
    paddle.seed(seed)
    jd = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                    normalize_before=True), layers,
        norm=jnn.LayerNorm(E))
    jd.eval()
    pd = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(E, H, FF, dropout=0.0,
                                   normalize_before=True, device="cpu"),
        layers, norm=nn.LayerNorm(E, device="cpu"))
    return jd, _carry(jd, pd)


def test_decoder_forward_and_gen_cache_match_jax():
    jd, pd = _decoder_pair()
    tgt, mem = _x(17, 2, 6, E), _x(18, 2, 8, E)
    with torch.no_grad():
        out = pd(torch.from_numpy(tgt), torch.from_numpy(mem),
                 nn.CAUSAL_MASK)
    jout = jd(_j(tgt), _j(mem), jnn.CAUSAL_MASK)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    pc = pd.gen_cache(torch.from_numpy(mem))
    jc = jd.gen_cache(_j(mem))
    assert len(pc) == len(jc) == 2
    for (pinc, pst), (jinc, jst) in zip(pc, jc):
        assert tuple(pinc.k.shape) == tuple(jinc.k.shape) == (2, H, 0, 32)
        np.testing.assert_allclose(_np(pst.k), _np(jst.k), **TOL)
        np.testing.assert_allclose(_np(pst.v), _np(jst.v), **TOL)
    zipped = pd.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert all(isinstance(c, nn.MultiHeadAttention.Cache)
               for c in zipped[0])
    assert all(isinstance(c, nn.MultiHeadAttention.StaticCache)
               for c in zipped[1])


def test_decoder_steps_with_cache_equal_full_forward():
    """Six one-token steps fed back through the returned caches equal the
    full causal forward row by row."""
    _, pd = _decoder_pair(seed=19)
    tgt, mem = _x(20, 2, 6, E), _x(21, 2, 8, E)
    with torch.no_grad():
        full = pd(torch.from_numpy(tgt), torch.from_numpy(mem),
                  nn.CAUSAL_MASK)
        cache = pd.gen_cache(torch.from_numpy(mem))
        for t in range(6):
            out, cache = pd(torch.from_numpy(tgt[:, t:t + 1]),
                            torch.from_numpy(mem), nn.CAUSAL_MASK, None,
                            cache)
            np.testing.assert_allclose(_np(out)[:, 0], _np(full)[:, t],
                                       **TOL)
    assert tuple(cache[0][0].k.shape) == (2, H, 6, 32)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_and_names_match_jax(normalize_before):
    paddle.seed(22)
    jt = jnn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                         normalize_before=normalize_before)
    jt.eval()
    pt = nn.Transformer(E, H, 2, 2, FF, dropout=0.0,
                        normalize_before=normalize_before, device="cpu")
    jsd, psd = jt.state_dict(), pt.state_dict()
    assert sorted(jsd) == sorted(psd)
    assert any(".cross_attn.q_proj.weight" in k for k in psd)
    assert any(".norm3.bias" in k for k in psd)
    _carry(jt, pt)
    src, tgt = _x(23, 2, 7, E), _x(24, 2, 5, E)
    jmask = jt.generate_square_subsequent_mask(5)
    pmask = pt.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(_np(pmask), _np(jmask))
    with torch.no_grad():
        out = pt(torch.from_numpy(src), torch.from_numpy(tgt),
                 tgt_mask=pmask)
    jout = jt(_j(src), _j(tgt), tgt_mask=jmask)
    assert tuple(out.shape) == (2, 5, E)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)


@pytest.mark.parametrize("cls,args", [
    (nn.MultiHeadAttention, (E, H)),
    (nn.TransformerDecoderLayer, (E, H, FF)),
    (nn.Transformer, (E, H, 1, 1, FF)),
], ids=["mha", "decoder_layer", "transformer"])
def test_param_attr_raises_naming_a2(cls, args):
    """ParamAttr came with queue A2's dense slice: the layer takes it, and
    every Linear inside gets its initializer and its attributes."""
    attr = P.ParamAttr(initializer=P.nn.initializer.Constant(0.25),
                       learning_rate=0.5, need_clip=False)
    layer = cls(*args, weight_attr=attr, bias_attr=False, device="cpu")
    linears = [m for m in layer.modules() if isinstance(m, nn.Linear)]
    assert linears
    for lin in linears:
        assert torch.equal(lin.weight.detach(),
                           torch.full_like(lin.weight, 0.25))
        assert lin.bias is None
        assert lin.weight.optimize_attr["learning_rate"] == 0.5
        assert lin.weight.need_clip is False


def test_gpt_incremental_forward_matches_jax_and_full():
    """The GPT with a concat cache: positions start after the cached
    prefix, and each step's logits equal the full forward's row and the
    JAX package's step."""
    cfg = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=32, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    paddle.seed(25)
    jm = JGPT(JGPTConfig(**cfg))
    jm.eval()
    pm = _carry(jm, GPTForCausalLM(GPTConfig(**cfg), device="cpu"))
    ids = np.random.default_rng(26).integers(0, 64, (2, 7)).astype(np.int32)
    with torch.no_grad():
        full = pm(torch.from_numpy(ids))
        pc = pm.gpt.gen_cache(torch.from_numpy(ids))
        logits, pc = pm(torch.from_numpy(ids[:, :4]), cache=pc)
    jc = jm.gpt.gen_cache(_j(ids))
    jlogits, jc = jm(_j(ids[:, :4]), cache=jc)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    for t in range(4, 7):
        with torch.no_grad():
            logits, pc = pm(torch.from_numpy(ids[:, t:t + 1]), cache=pc)
        jlogits, jc = jm(_j(ids[:, t:t + 1]), cache=jc)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        np.testing.assert_allclose(_np(logits)[:, 0], _np(full)[:, t],
                                   **TOL)
    assert tuple(pc[0].k.shape) == (2, 2, 7, 32)
