"""Training through ``Model.train_batch`` against the JAX package's
``paddle.Model`` at the ``entry()`` flagship config (vocab 256, hidden
128, 2 layers, 4 heads, seq 32, batch [4, 32]), dense and flash: step-1
gradients, the parameters after one AdamW step, a 10-step loss curve,
gradient accumulation, eval, ``fit`` with the LRScheduler callback,
save/load, the losses, and the seeded dropout generator."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainingCriterion as JCrit  # noqa: E402
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.hapi.callbacks import LRScheduler  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
tfa = importlib.import_module(  # noqa: E402
    "paddle_tpu_torch.ops.flash_attention")

FLAGSHIP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                intermediate_size=512, max_position_embeddings=32,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
IMPLS = ["dense", "flash"]


def _ids(seed=0):
    # entry()'s example input: RandomState(0) ints in [0, 256), [4, 32]
    return np.random.RandomState(seed).randint(0, 256, (4, 32)).astype(
        np.int32)


def _sched(pkg):
    return pkg.lr.LinearWarmup(pkg.lr.CosineAnnealingDecay(1e-3, 20), 3,
                               1e-4, 1e-3)


# Adam's epsilon. With the default 1e-8, Adam moves a weight whose
# gradient is zero up to rounding by a rounding-driven fraction of lr, which
# differs between the packages. k_proj.bias has such a gradient in every
# layer (softmax ignores a score shift shared by all keys), so the
# parameter comparisons use 1e-6, which keeps that motion below 1e-6.
EPS = 1e-6


def _jax_model(impl):
    """A JAX paddle.Model with AdamW (decay 0.01, global-norm clip 1.0,
    warmup+cosine) and the GPT criterion, and its initial weights."""
    paddle.seed(0)
    net = JGPT(JGPTConfig(**FLAGSHIP, attn_impl=impl))
    arrays = {k: np.array(v._data) for k, v in net.state_dict().items()}
    sched = _sched(jopt)
    opt = jopt.AdamW(learning_rate=sched, parameters=net.parameters(),
                     epsilon=EPS, weight_decay=0.01, grad_clip=JClip(1.0))
    model = paddle.Model(net)
    model.prepare(opt, JCrit())
    return model, net, sched, arrays


def _port_model(impl, arrays):
    """The same model, optimizer and criterion in the port, on the CPU,
    with the JAX weights carried in."""
    net = GPTForCausalLM(GPTConfig(**FLAGSHIP, attn_impl=impl), device="cpu",
                         seed=1)
    net.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    sched = _sched(topt)
    opt = topt.AdamW(learning_rate=sched, parameters=net.parameters(),
                     epsilon=EPS, weight_decay=0.01,
                     grad_clip=ClipGradByGlobalNorm(1.0), device="cpu")
    model = P.Model(net, device="cpu")
    model.prepare(opt, GPTPretrainingCriterion())
    return model, net, sched


def _jax_params(net):
    return {k: np.array(v._data) for k, v in net.state_dict().items()}


def _assert_params_close(tnet, jparams, atol):
    for k, v in tnet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jparams[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module", params=IMPLS)
def reference(request):
    """The JAX side once per attention impl: step-1 gradients
    (train_batch(update=False)), the parameters after one step and the
    10-step loss curve."""
    impl = request.param
    model, net, sched, arrays = _jax_model(impl)
    ids = _ids()
    model.train_batch([ids], [ids], update=False)
    grads = {n: np.array(p._grad) for n, p in net.named_parameters()}
    model._optimizer.clear_grad()
    losses, params1 = [], None
    for i in range(10):
        losses.append(model.train_batch([ids], [ids])[0])
        sched.step()
        if i == 0:
            params1 = _jax_params(net)
    return dict(impl=impl, arrays=arrays, grads=grads, params1=params1,
                losses=losses)


def test_step1_gradients_match_jax(reference):
    model, net, _ = _port_model(reference["impl"], reference["arrays"])
    ids = _ids()
    before = tfa.flash_attention_fwd.launches
    model.train_batch([ids], [ids], update=False)
    assert tfa.flash_attention_fwd.launches == before      # CPU: no launch
    top = max(np.abs(g).max() for g in reference["grads"].values())
    for n, p in net.named_parameters():
        ref = reference["grads"][n]
        assert p.grad is not None, n
        if n.endswith("k_proj.bias"):
            # zero up to rounding in both packages: softmax ignores a
            # score shift shared by all keys
            assert np.abs(ref).max() < 1e-6 * top
            assert float(p.grad.abs().max()) < 1e-6 * top
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=n)


def test_one_step_and_ten_step_loss_curve_match_jax(reference):
    model, net, sched = _port_model(reference["impl"], reference["arrays"])
    ids = _ids()
    losses = []
    for i in range(10):
        loss, metrics = model.train_batch([ids], [ids])
        assert metrics == [] and isinstance(loss, float)
        losses.append(loss)
        sched.step()
        if i == 0:
            _assert_params_close(net, reference["params1"], 1e-5)
    np.testing.assert_allclose(losses, reference["losses"], rtol=0,
                               atol=1e-4)
    assert losses[-1] < losses[0]


def test_accumulation_and_eval_match_jax():
    jm, jnet, _, arrays = _jax_model("dense")
    tm, tnet, _ = _port_model("dense", arrays)
    a, b, c = _ids(1), _ids(2), _ids(3)
    for m in (jm, tm):
        m.train_batch([a], [a], update=False)
        m.train_batch([b], [b], update=True)
    _assert_params_close(tnet, _jax_params(jnet), 1e-5)
    assert all(p.grad is None for p in tnet.parameters())
    jl, _ = jm.eval_batch([c], [c])
    tl, metrics = tm.eval_batch([torch.from_numpy(c)], [c])
    assert metrics == [] and abs(tl - jl) < 1e-5
    assert tm.eval_batch([c])[0] is None
    jp = np.asarray(jm.predict_batch([c])._data)
    tp = tm.predict_batch([c])
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5, atol=1e-5)


def test_fit_with_lr_scheduler_callback_and_save_load_match_jax(tmp_path):
    jm, jnet, jsched, arrays = _jax_model("flash")
    tm, tnet, tsched = _port_model("flash", arrays)
    batches = [(_ids(s), _ids(s)) for s in range(3)]
    jm.fit(batches, epochs=2, verbose=0)
    tm.fit(batches, epochs=2, verbose=0, callbacks=[LRScheduler()])
    assert tsched.last_epoch == jsched.last_epoch == 6
    _assert_params_close(tnet, _jax_params(jnet), 1e-4)
    assert abs(tm.evaluate(batches, verbose=0)["loss"]
               - jm.evaluate(batches, verbose=0)["loss"]) < 1e-4
    # save from the JAX package, load into fresh models of both packages,
    # and keep training: the runs continue together
    jpath = str(tmp_path / "jax_ckpt")
    jm.save(jpath)
    jm2, jnet2, jsched2, _ = _jax_model("flash")
    jm2.load(jpath)
    tm2, tnet2, tsched2 = _port_model("flash", arrays)
    tm2.load(jpath)
    assert tm2._optimizer._global_step == 6 == tsched2.last_epoch
    tpath = str(tmp_path / "port_ckpt")
    tm2.save(tpath)
    saved = {k: v.clone() for k, v in tnet2.state_dict().items()}
    saved_opt = sorted(tm2._optimizer.state_dict())
    for m, s in ((jm2, jsched2), (tm2, tsched2)):
        for x, y in batches[:2]:
            m.train_batch([x], [y])
            s.step()
    _assert_params_close(tnet2, _jax_params(jnet2), 1e-4)
    # the port's own files round-trip
    tm3, tnet3, _ = _port_model("flash", arrays)
    tm3.load(tpath)
    for k, v in tnet3.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert sorted(tm3._optimizer.state_dict()) == saved_opt
    assert tm3._optimizer._global_step == 6


def test_parameter_the_loss_does_not_reach_is_updated_as_in_jax():
    """A trainable parameter outside the loss gets a zero gradient, as the
    JAX step's value_and_grad gives it, so AdamW still decays it."""
    from paddle_tpu import nn as jnn
    from paddle_tpu_torch import nn as tnn

    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.used = jnn.Linear(3, 2)
            self.unused = jnn.Linear(3, 2)

        def forward(self, x):
            return self.used(x)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = tnn.Linear(3, 2, device="cpu")
            self.unused = tnn.Linear(3, 2, device="cpu")

        def forward(self, x):
            return self.used(x)

    jnet, tnet = JNet(), TNet()
    tnet.load_state_dict(P.state_dict_from_reference(
        _jax_params(jnet), "cpu"))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    y = rng.standard_normal((4, 2)).astype(np.float32)
    jm = paddle.Model(jnet)
    jm.prepare(jopt.AdamW(learning_rate=0.1, weight_decay=0.5,
                          parameters=jnet.parameters()),
               lambda p, t: ((p - t) ** 2).mean())
    tm = P.Model(tnet, device="cpu")
    tm.prepare(topt.AdamW(learning_rate=0.1, weight_decay=0.5,
                          parameters=tnet.parameters(), device="cpu"),
               lambda p, t: ((p - t) ** 2).mean())
    w0 = tnet.unused.weight.detach().clone()
    for _ in range(2):
        jm.train_batch([x], [y])
        tm.train_batch([x], [y])
    _assert_params_close(tnet, _jax_params(jnet), 1e-6)
    # zero gradient: decoupled decay only, (1 - lr * coeff) per step
    torch.testing.assert_close(tnet.unused.weight.detach(), w0 * 0.95 ** 2)


def test_unported_options_raise():
    net = torch.nn.Linear(2, 2)
    m = P.Model(net, device="cpu")
    # metrics and Dataset/DataLoader inputs are ported (A9's gates went)
    m.prepare(None, None, metrics=P.metric.Accuracy())
    assert len(m._metrics) == 1
    with pytest.raises(NotImplementedError, match="A4"):
        m.prepare(None, None, amp_configs={"level": "O1"})
    # the step meter is ported: attach_step_meter now publishes
    from paddle_tpu_torch.core.monitor import StatRegistry
    from paddle_tpu_torch.observability import StepMeter
    reg = StatRegistry()
    meter = m.attach_step_meter(StepMeter(registry=reg, device="cpu"))
    assert meter.peak_flops == 1.0e12      # the CPU's proxy peak
    m.prepare(topt.SGD(parameters=net.parameters(), device="cpu"),
              torch.nn.functional.mse_loss)
    zeros = np.zeros((2, 2), np.float32)
    m.fit(P.io.TensorDataset([zeros, zeros]), batch_size=2, verbose=0)
    # the forward's and the weight gradient's [2, 2] x [2, 2] products,
    # 8 multiply-adds each (the input needs no gradient)
    assert reg.get("train.flops_per_step") == 2 * (2 * 2 * 2)
    assert reg.get("train.mfu") > 0
    assert reg.histogram("train.step_ms")["count"] == 1
    with pytest.raises(RuntimeError, match="prepare"):
        P.Model(net, device="cpu").train_batch([np.zeros((1, 2))])
    with pytest.raises(ValueError, match="device"):
        P.Model(net.to("meta"), device="cpu")


def _jax_ce(*args, **kw):
    conv = [Tensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a
            for a in args]
    out = JF.cross_entropy(*conv, **kw)
    return np.asarray(out._data)


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=3), dict(ignore_index=3, weight=True),
    dict(weight=True, reduction="sum"), dict(use_softmax=False),
    dict(axis=1), dict(label_col=True)],
    ids=["mean", "sum", "none", "ignore", "ignore_weight", "weight_sum",
         "probs", "axis1", "label_col"])
def test_cross_entropy_matches_jax(kw):
    kw = dict(kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    lab = rng.integers(0, 5, 6).astype(np.int32)
    lab[:2] = 3
    args_j, args_t = [x, lab], [torch.from_numpy(x), torch.from_numpy(lab)]
    if kw.pop("use_softmax", True) is False:
        p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        args_j[0], args_t[0] = p, torch.from_numpy(p)
        kw["use_softmax"] = False
    if kw.pop("axis", None) == 1:
        x3 = rng.standard_normal((2, 5, 3)).astype(np.float32)
        l3 = rng.integers(0, 5, (2, 3)).astype(np.int32)
        args_j, args_t = [x3, l3], [torch.from_numpy(x3),
                                    torch.from_numpy(l3)]
        kw["axis"] = 1
    if kw.pop("label_col", False):
        args_j[1] = lab[:, None]
        args_t[1] = torch.from_numpy(lab[:, None].copy())
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight"):
        w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
        jkw["weight"], tkw["weight"] = Tensor(jnp.asarray(w)), \
            torch.from_numpy(w)
    ref = _jax_ce(*args_j, **jkw)
    out = F.cross_entropy(*args_t, **tkw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_soft_label_and_nll_and_softmax_with_ce_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    soft = rng.uniform(size=(4, 6)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        F.cross_entropy(torch.from_numpy(x), torch.from_numpy(soft),
                        soft_label=True).numpy(),
        _jax_ce(x, soft, soft_label=True), rtol=1e-6, atol=1e-6)
    lab = np.array([0, 5, 2, 2], np.int32)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    w = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    ref = JF.nll_loss(Tensor(jnp.asarray(logp)), Tensor(jnp.asarray(lab)),
                      weight=Tensor(jnp.asarray(w)), ignore_index=5)
    out = F.nll_loss(torch.from_numpy(logp), torch.from_numpy(lab),
                     weight=torch.from_numpy(w), ignore_index=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data),
                               rtol=1e-6, atol=1e-6)
    jl, js = JF.softmax_with_cross_entropy(
        Tensor(jnp.asarray(x)), Tensor(jnp.asarray(lab[:, None])),
        return_softmax=True)
    tl, ts = F.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(lab[:, None].copy()),
        return_softmax=True)
    assert tuple(tl.shape) == (4, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js._data), rtol=1e-6,
                               atol=1e-6)


def test_pretraining_criterion_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    ref = JCrit()(Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(labels)))
    out = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref._data), rtol=1e-6,
                               atol=1e-6)


def _dropout_step(seed):
    """One train_batch of a GPT with dropout 0.1 (dense attention, as the
    flash path refuses attention dropout in training) after seed(seed)."""
    cfg = dict(FLAGSHIP, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    net = GPTForCausalLM(GPTConfig(**cfg, attn_impl="auto"), device="cpu",
                         seed=0)
    model = P.Model(net, device="cpu")
    model.prepare(topt.AdamW(parameters=net.parameters(), device="cpu"),
                  GPTPretrainingCriterion())
    P.seed(seed)
    ids = _ids()
    loss, _ = model.train_batch([ids], [ids])
    return loss, [p.detach().clone() for p in net.parameters()]


def test_seed_makes_a_dropout_training_step_repeat_bit_for_bit():
    loss_a, params_a = _dropout_step(5)
    torch.manual_seed(123)          # torch's global generator is not used
    loss_b, params_b = _dropout_step(5)
    loss_c, _ = _dropout_step(6)
    assert loss_a == loss_b
    assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))
    assert loss_c != loss_a
    state = P.core.generator.get_rng_state()
    x = F.dropout(torch.ones(64), 0.5)
    P.core.generator.set_rng_state(state)
    assert torch.equal(F.dropout(torch.ones(64), 0.5), x)
