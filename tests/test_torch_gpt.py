"""The GPT forward of the port against the JAX package at the ``entry()``
flagship config (vocab 256, hidden 128, 2 layers, 4 heads, seq 32), and
the weight carry between the packages both ways."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.nn import LayerNorm as JLayerNorm  # noqa: E402
from paddle_tpu.nn import Linear as JLinear  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.nn import LayerNorm, Linear  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
tfa = importlib.import_module(  # noqa: E402
    "paddle_tpu_torch.ops.flash_attention")

FLAGSHIP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                intermediate_size=512, max_position_embeddings=32,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _jax_model(attn_impl, seed=0):
    paddle.seed(seed)
    m = JGPT(JGPTConfig(**FLAGSHIP, attn_impl=attn_impl))
    m.eval()
    return m


def _arrays(jmodel):
    return {k: np.asarray(v._data) for k, v in jmodel.state_dict().items()}


def _port_from(jmodel, attn_impl):
    m = GPTForCausalLM(GPTConfig(**FLAGSHIP, attn_impl=attn_impl),
                       device="cpu", seed=1).eval()
    m.load_state_dict(framework_io.state_dict_from_reference(
        _arrays(jmodel), "cpu"), strict=True)
    return m


def _ids(seed=0):
    # entry()'s example input: RandomState(0) ints in [0, 256), [4, 32]
    return np.random.RandomState(seed).randint(0, 256, (4, 32)).astype(
        np.int32)


def test_state_dict_names_match_one_to_one():
    jm = _jax_model("dense")
    pm = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu")
    jsd, psd = jm.state_dict(), pm.state_dict()
    assert sorted(jsd) == sorted(psd)
    for k in jsd:
        assert tuple(jsd[k].shape) == tuple(psd[k].shape), k


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_logits_match_jax_flagship(attn_impl):
    jm = _jax_model(attn_impl)
    pm = _port_from(jm, attn_impl)
    ids = _ids()
    ref = np.asarray(jm(Tensor(jnp.asarray(ids)))._data)
    before = tfa.flash_attention_fwd.launches
    with torch.no_grad():
        out = pm(torch.from_numpy(ids)).numpy()
    assert out.shape == (4, 32, 256)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert tfa.flash_attention_fwd.launches == before   # CPU: no launch


def test_flash_and_dense_agree_in_the_port():
    pm = GPTForCausalLM(GPTConfig(**FLAGSHIP, attn_impl="flash"),
                        device="cpu", seed=3).eval()
    ids = torch.from_numpy(_ids(1))
    with torch.no_grad():
        flash = pm(ids)
        pm.set_attn_impl("dense")
        dense = pm(ids)
    torch.testing.assert_close(flash, dense, rtol=1e-5, atol=1e-5)


def test_carry_through_paddle_save_pickle(tmp_path):
    jm = _jax_model("dense", seed=5)
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(jm.state_dict(), path)
    loaded = framework_io.load(path)
    assert all(isinstance(v, torch.Tensor) for v in loaded.values())
    pm = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu").eval()
    pm.load_state_dict(loaded, strict=True)
    ids = _ids(2)
    ref = np.asarray(jm(Tensor(jnp.asarray(ids)))._data)
    with torch.no_grad():
        out = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_port_save_loads_into_jax_bitwise(tmp_path):
    pm = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu", seed=7)
    path = str(tmp_path / "port.pdparams")
    framework_io.save(pm.state_dict(), path)
    jm = _jax_model("dense")
    jm.set_state_dict(paddle.load(path))
    jsd = _arrays(jm)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(jsd[k], v.numpy())
    back = framework_io.load(path, return_numpy=True)
    assert sorted(back) == sorted(jsd)


def test_seeded_init_is_deterministic_and_layers_differ():
    a = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu", seed=11)
    b = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu", seed=11)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w0 = a.gpt.decoder.layers[0].linear1.weight
    w1 = a.gpt.decoder.layers[1].linear1.weight
    assert not torch.equal(w0, w1)
    emb = a.gpt.word_embeddings.weight
    assert abs(emb.std().item() - 0.02) < 0.002


def test_functional_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32)
    w = rng.standard_normal(16, dtype=np.float32)
    b = rng.standard_normal(16, dtype=np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        F.gelu(tx).numpy(), np.asarray(JF.gelu(Tensor(jnp.asarray(x)))._data),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        F.softmax(tx).numpy(),
        np.asarray(JF.softmax(Tensor(jnp.asarray(x)))._data),
        rtol=1e-6, atol=1e-6)
    jln = JF.layer_norm(Tensor(jnp.asarray(x)), 16,
                        Tensor(jnp.asarray(w)), Tensor(jnp.asarray(b)))
    np.testing.assert_allclose(
        F.layer_norm(tx, 16, torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jln._data), rtol=1e-5, atol=1e-5)


def test_linear_and_layernorm_layers_carry():
    jlin, jln = JLinear(16, 8), JLayerNorm(8)
    plin = Linear(16, 8, device="cpu")
    pln = LayerNorm(8, device="cpu")
    plin.load_state_dict(framework_io.state_dict_from_reference(
        {k: np.asarray(v._data) for k, v in jlin.state_dict().items()},
        "cpu"))
    assert tuple(plin.weight.shape) == (16, 8)        # paddle's [in, out]
    x = np.random.default_rng(1).standard_normal((4, 16), dtype=np.float32)
    ref = np.asarray(jln(jlin(Tensor(jnp.asarray(x))))._data)
    with torch.no_grad():
        out = pln(plin(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_dropout_modes():
    x = torch.ones(1000)
    assert torch.equal(F.dropout(x, 0.5, training=False), x)
    torch.testing.assert_close(
        F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    g = torch.Generator().manual_seed(0)
    y = F.dropout(x, 0.5, training=True, generator=g)
    kept = y[y != 0]
    assert torch.all(kept == 2.0) and 300 < kept.numel() < 700
