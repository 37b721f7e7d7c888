"""``distributed/fleet/utils.py`` of the port against the JAX package's:
``recompute`` (outputs and gradients at 1e-5, as
``tests/test_fleet_tp_sharding.py::TestRecompute``; bench.py's GPT with
every decoder block recomputed, 2 layers at S = 64, loss and gradients
at 1e-5 through ``Model.train_batch``), dropout under recompute
(gradients bitwise equal to the step without it, the generator left
where it would be), and ``GradientMergeOptimizer`` over k = 1, 2, 4 with
and without averaging."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.distributed.fleet import utils as jutils  # noqa: E402
from paddle_tpu.jit import to_static  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainingCriterion as JCrit  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.core import generator  # noqa: E402
from paddle_tpu_torch.distributed.fleet import utils  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

TOL = 1e-5
# bench.py:290-295, the GPT at S = 4096 at its CPU size
GPT_CPU = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=128, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0, attn_impl="auto")
GPT_BATCH = (1, 64)


def _arrays(jlayer):
    return {k: np.array(v._data) for k, v in jlayer.state_dict().items()}


class _JNet(jnn.Layer):
    def __init__(self, d_in, d_hidden, act):
        super().__init__()
        self.a = jnn.Linear(d_in, d_hidden)
        self.b = jnn.Linear(d_hidden, d_in if act == "relu" else 1)
        self.act = act
        self.use_rc = False

    def forward(self, x):
        act = (paddle.nn.functional.relu if self.act == "relu"
               else paddle.tanh)
        if self.use_rc:
            h = jutils.recompute(lambda v: act(self.a(v)), x)
        else:
            h = act(self.a(x))
        return self.b(h)


class _TNet(torch.nn.Module):
    def __init__(self, d_in, d_hidden, act, p=0.0):
        super().__init__()
        self.a = tnn.Linear(d_in, d_hidden, device="cpu")
        self.b = tnn.Linear(d_hidden, d_in if act == "relu" else 1,
                            device="cpu")
        self.drop = tnn.Dropout(p)
        self.act = torch.relu if act == "relu" else torch.tanh
        self.use_rc = False
        self.calls = 0

    def block(self, v):
        self.calls += 1
        return self.drop(self.act(self.a(v)))

    def forward(self, x):
        self.h = utils.recompute(self.block, x) if self.use_rc \
            else self.block(x)
        return self.b(self.h)


def _port_net(jnet, *args, **kw):
    tnet = _TNet(*args, **kw)
    tnet.load_state_dict(P.state_dict_from_reference(_arrays(jnet), "cpu"),
                         strict=False)
    return tnet


# -- recompute ----------------------------------------------------------------

def test_recompute_numerics_identical():
    """TestRecompute.test_recompute_numerics_identical: the JAX package
    recomputes under to_static; the port's output with recompute equals
    its output without, and both the JAX package's at 1e-5."""
    paddle.seed(5)
    jnet = _JNet(8, 32, "relu")
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    jnet.use_rc = True
    jout = to_static(jnet)(paddle.to_tensor(x)).numpy()
    tnet = _port_net(jnet, 8, 32, "relu")
    plain = tnet(torch.from_numpy(x))
    tnet.use_rc = True
    rc = tnet(torch.from_numpy(x))
    assert torch.equal(rc, plain)
    np.testing.assert_allclose(rc.detach().numpy(), jout, rtol=0, atol=TOL)


def test_recompute_grads_match():
    """TestRecompute.test_recompute_grads_match: gradients with recompute
    equal those without (bitwise here) and the JAX package's recomputed
    ones at 1e-5; the block runs twice, the second time in the
    backward."""
    paddle.seed(7)
    jnet = _JNet(4, 16, "tanh")
    jnet.use_rc = True
    x = np.random.RandomState(1).randn(8, 4).astype(np.float32)
    loss = paddle.mean(to_static(jnet)(paddle.to_tensor(x)) ** 2)
    loss.backward()
    jgrad = jnet.a.weight.grad.numpy()

    def grads(use_rc):
        tnet = _port_net(jnet, 4, 16, "tanh")
        tnet.use_rc = use_rc
        torch.mean(tnet(torch.from_numpy(x)) ** 2).backward()
        return tnet.a.weight.grad, tnet.calls
    (g_rc, calls_rc), (g, calls) = grads(True), grads(False)
    assert (calls_rc, calls) == (2, 1)
    assert torch.equal(g_rc, g)
    np.testing.assert_allclose(g_rc.numpy(), jgrad, rtol=0, atol=TOL)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_masks_reused_bitwise(p):
    """With dropout and the same seed, recompute's gradients equal those
    without it bit for bit: the re-run reuses the forward's masks and
    draws nothing, so the generator ends where it would without
    recompute (the next draw is the same)."""
    paddle.seed(3)
    jnet = _JNet(8, 32, "tanh")
    x = torch.from_numpy(np.random.RandomState(2).randn(16, 8).astype(
        np.float32))

    def run(use_rc):
        tnet = _port_net(jnet, 8, 32, "tanh", p=p)
        tnet.use_rc = use_rc
        P.seed(11)
        out = tnet(x)
        (out ** 2).sum().backward()
        after = generator.default_generator("cpu").get_state()
        return (tnet.h, [q.grad for q in tnet.parameters()], after,
                tnet.calls)
    h_rc, g_rc, after_rc, calls = run(True)
    h, g, after, _ = run(False)
    assert calls == 2
    assert (h == 0).any() and torch.equal(h_rc, h)
    assert all(torch.equal(a, b) for a, b in zip(g_rc, g))
    assert torch.equal(after_rc, after)


def test_recompute_rerun_keeps_the_forward_amp_state():
    """A block recomputed in a backward that runs outside ``auto_cast``
    re-runs under the forward's O1 state: its gradient equals the one
    without recompute."""
    paddle.seed(4)
    jnet = _JNet(8, 32, "relu")
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 8).astype(
        np.float32))

    def grad(use_rc):
        tnet = _port_net(jnet, 8, 32, "relu")
        tnet.use_rc = use_rc
        with amp.auto_cast():
            out = tnet(x)
        out.float().sum().backward()
        return tnet.a.weight.grad
    assert torch.equal(grad(True), grad(False))


def test_recompute_options_and_nesting():
    """``use_reentrant`` and ``preserve_rng_state`` are taken and popped;
    a recompute inside a recomputed function runs its function directly;
    keyword arguments reach the function."""
    calls = []

    def inner(v, scale=1.0):
        calls.append("inner")
        return torch.sin(v) * scale

    def outer(v):
        calls.append("outer")
        return utils.recompute(inner, v, scale=2.0, use_reentrant=True)

    x = torch.randn(5, requires_grad=True)
    y = utils.recompute(outer, x, preserve_rng_state=False,
                        use_reentrant=False)
    y.sum().backward()
    torch.testing.assert_close(y, torch.sin(x) * 2.0, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, torch.cos(x) * 2.0)
    assert calls == ["outer", "inner", "outer", "inner"]


def _recompute_blocks(net, num_layers, rc):
    """bench.py:296-301: every decoder block's forward through
    ``recompute``."""
    names = tuple(f"layers.{i}" for i in range(num_layers))
    subs = net.named_sublayers() if hasattr(net, "named_sublayers") \
        else net.named_modules()
    for name, sub in subs:
        if name.endswith(names):
            orig = sub.forward
            sub.forward = (lambda *a, __f=orig, **k: rc(__f, *a, **k))


@pytest.fixture(scope="module")
def gpt_reference():
    """bench.py's GPT at its CPU size through the JAX package's Model,
    every block recomputed (under the train step's trace, jax.checkpoint):
    step-1 loss and gradients, then a 3-step AdamW curve."""
    paddle.seed(0)
    net = JGPT(JGPTConfig(**GPT_CPU))
    arrays = _arrays(net)
    _recompute_blocks(net, GPT_CPU["num_layers"], jutils.recompute)
    m = paddle.Model(net)
    m.prepare(jopt.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                         weight_decay=0.01), JCrit())
    ids = np.random.RandomState(0).randint(
        0, GPT_CPU["vocab_size"], GPT_BATCH).astype(np.int32)
    loss = m.train_batch([ids], [ids.astype(np.int64)], update=False)[0]
    grads = {n: np.array(p._grad) for n, p in net.named_parameters()}
    return dict(arrays=arrays, ids=ids, loss=loss, grads=grads)


def _port_gpt(arrays, rc):
    net = GPTForCausalLM(GPTConfig(**GPT_CPU), device="cpu", seed=1)
    net.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    if rc:
        _recompute_blocks(net, GPT_CPU["num_layers"], utils.recompute)
    m = P.Model(net, device="cpu")
    m.prepare(topt.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                         weight_decay=0.01, device="cpu"),
              GPTPretrainingCriterion())
    return m, net


def test_gpt_recompute_matches_jax(gpt_reference):
    """The port's GPT with every block recomputed: its step-1 loss and
    gradients against the JAX package's at 1e-5 (of the largest), and
    bitwise equal to the same step without recompute; the flash route
    runs B1 twice a layer (forward and re-run) and B2/B3 once."""
    ref = gpt_reference
    ids = ref["ids"]
    out = {}
    for rc in (True, False):
        m, net = _port_gpt(ref["arrays"], rc)
        loss = m.train_batch([ids], [ids.astype(np.int64)],
                             update=False)[0]
        out[rc] = loss, {n: p.grad for n, p in net.named_parameters()}
    loss, grads = out[True]
    assert abs(loss - ref["loss"]) / abs(ref["loss"]) < TOL
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][n], rtol=0,
                                   atol=TOL * top, err_msg=n)
    assert loss == out[False][0]
    assert all(torch.equal(g, out[False][1][n]) for n, g in grads.items())


def test_gpt_recompute_runs_attention_forward_twice_a_layer(monkeypatch):
    """The flash route under recompute: attention's forward runs in the
    forward and again in the re-run, its backward once, each layer. On
    the CPU the wrappers take their plain versions, counted here; on the
    card the same calls launch B1 twice and B2 and B3 once a layer."""
    m, _ = _port_gpt(_arrays(JGPT(JGPTConfig(**GPT_CPU))), True)
    ids = np.random.RandomState(0).randint(0, GPT_CPU["vocab_size"],
                                           GPT_BATCH)
    calls = {"fwd": 0, "bwd": 0}

    def counting(name, key):
        plain = getattr(tfa, name)

        def run(*a, **k):
            calls[key] += 1
            return plain(*a, **k)
        monkeypatch.setattr(tfa, name, run)
    counting("flash_attention_fwd_plain", "fwd")
    counting("flash_attention_bwd_plain", "bwd")
    m.train_batch([ids], [ids])
    layers = GPT_CPU["num_layers"]
    assert calls == {"fwd": 2 * layers, "bwd": layers}


# -- gradient merge and LocalSGD ----------------------------------------------

@pytest.mark.parametrize("avg", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_gradient_merge_matches_jax(k, avg):
    """GradientMergeOptimizer around Momentum over 8 micro-steps of
    random gradients: parameters after each micro-step against the JAX
    package's at 1e-6; nothing moves until the k-th micro-step."""
    rng = np.random.RandomState(k)
    w0 = rng.randn(6).astype(np.float32)
    grads = rng.randn(8, 6).astype(np.float32)
    jp = paddle.Parameter(w0.copy())
    jo = jutils.GradientMergeOptimizer(
        jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[jp]),
        k_steps=k, avg=avg)
    tp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = utils.GradientMergeOptimizer(
        topt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[tp],
                      device="cpu"), k_steps=k, avg=avg)
    for i, g in enumerate(grads):
        jp._grad = paddle.to_tensor(g)._data
        jo.step()
        tp.grad = torch.from_numpy(g.copy())
        to.step()
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                   rtol=0, atol=1e-6, err_msg=f"step {i}")
        if i < k - 1:
            np.testing.assert_array_equal(tp.detach().numpy(), w0)
    assert to.get_lr() == 0.1      # the inner optimizer's attributes


def test_local_sgd_raises_naming_a10():
    opt = topt.SGD(learning_rate=0.1, parameters=[torch.nn.Parameter(
        torch.zeros(2))], device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        utils.LocalSGDOptimizer(opt, k_steps=2)
