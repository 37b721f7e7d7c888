"""Automatic mixed precision (``paddle_tpu_torch.amp``) against the JAX
package's ``paddle_tpu.amp`` on the same numpy inputs: the output type of
every port op that consults the AMP hook, op by op, at O1 and O2, in
bfloat16 and float16, with custom lists; the ``entry()`` flagship GPT
(vocab 256, hidden 128, 2 layers, 4 heads, batch [4, 32]) under O1
bfloat16, dense and flash (logits, step-1 gradients, a 10-step AdamW loss
curve) and under O2 with ``decorate``; ``GradScaler``'s float16 recipe
(scale sequence, skipped steps, ``state_dict`` across the packages); and
the rest of the API. Output types must be equal; logits, losses and
gradients (relative to each tensor's max) agree at 2e-2, the repository's
bfloat16 tolerance; the scaler's scales and skips are equal."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.amp as jamp  # noqa: E402
import paddle_tpu.nn.functional as JF  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainingCriterion as JCrit  # noqa: E402
from paddle_tpu.ops.pallas_attention import (  # noqa: E402
    flash_attention as jflash)
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from paddle_tpu_torch.ops.math import matmul  # noqa: E402

TOL = 2e-2
FLAGSHIP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                intermediate_size=512, max_position_embeddings=32,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
# Adam's epsilon, as tests/test_torch_hapi_train.py explains: with 1e-8
# Adam moves weights whose gradient is zero but for rounding by a
# rounding-driven fraction of lr, differently in each package
EPS = 1e-6


@pytest.fixture(autouse=True)
def _restore_amp_state():
    """Every test leaves both packages' process-wide AMP state as it found
    it."""
    saved = dict(jamp._STATE), dict(amp._STATE)
    yield
    jamp._STATE.update(saved[0])
    amp._STATE.update(saved[1])


def _name(dtype):
    return str(dtype).replace("torch.", "")


# -- (a) output types, op by op ----------------------------------------------

def _f(*shape):
    return ("f", shape)


def _i(high, *shape):
    return ("i", high, shape)


# op: (inputs, reference call, port call); float inputs are float32 numpy
# arrays (or the low type, see _inputs), integer ones int64 in [0, high)
OPS = {
    "linear": ([_f(4, 8), _f(8, 6), _f(6)],
               lambda x, w, b: JF.linear(x, w, b),
               lambda x, w, b: F.linear(x, w, b)),
    "matmul": ([_f(4, 8), _f(6, 8)],
               lambda x, y: paddle.matmul(x, y, transpose_y=True),
               lambda x, y: matmul(x, y, transpose_y=True)),
    "softmax": ([_f(4, 8)], lambda x: JF.softmax(x), lambda x: F.softmax(x)),
    "cross_entropy": ([_f(6, 5), _i(5, 6)],
                      lambda x, y: JF.cross_entropy(x, y),
                      lambda x, y: F.cross_entropy(x, y)),
    "softmax_with_cross_entropy": (
        [_f(6, 5), _i(5, 6, 1)],
        lambda x, y: JF.softmax_with_cross_entropy(x, y),
        lambda x, y: F.softmax_with_cross_entropy(x, y)),
    "nll_loss": ([_f(6, 5), _i(5, 6)], lambda x, y: JF.nll_loss(x, y),
                 lambda x, y: F.nll_loss(x, y)),
    "layer_norm": ([_f(4, 8), _f(8), _f(8)],
                   lambda x, w, b: JF.layer_norm(x, 8, w, b),
                   lambda x, w, b: F.layer_norm(x, 8, w, b)),
    "batch_norm_eval": (
        [_f(2, 3, 4, 4), _f(3), ("pos", (3,)), _f(3), _f(3)],
        lambda x, m, v, w, b: JF.batch_norm(x, m, v, w, b, training=False),
        lambda x, m, v, w, b: F.batch_norm(x, m, v, w, b, training=False)),
    "batch_norm_train": (
        [_f(2, 3, 4, 4), _f(3), ("pos", (3,)), _f(3), _f(3)],
        lambda x, m, v, w, b: JF.batch_norm(x, m, v, w, b, training=True),
        lambda x, m, v, w, b: F.batch_norm(x, m, v, w, b, training=True)),
    "conv2d": ([_f(1, 2, 6, 6), _f(3, 2, 3, 3), _f(3)],
               lambda x, w, b: JF.conv2d(x, w, b, padding=1),
               lambda x, w, b: F.conv2d(x, w, b, padding=1)),
    "gelu": ([_f(4, 8)], lambda x: JF.gelu(x), lambda x: F.gelu(x)),
    "leaky_relu": ([_f(4, 8)], lambda x: JF.leaky_relu(x),
                   lambda x: F.leaky_relu(x)),
    "dropout": ([_f(4, 8)], lambda x: JF.dropout(x, 0.5, training=True),
                lambda x: F.dropout(x, 0.5, training=True)),
    "embedding": ([_i(10, 4), _f(10, 6)], lambda i, w: JF.embedding(i, w),
                  lambda i, w: F.embedding(i, w)),
    "interpolate": ([_f(1, 2, 3, 3)],
                    lambda x: JF.interpolate(x, scale_factor=2),
                    lambda x: F.interpolate(x, scale_factor=2)),
    "flash_attention": ([_f(1, 16, 2, 32)] * 3,
                        lambda q, k, v: jflash(q, k, v, causal=True)[0],
                        lambda q, k, v: flash_attention(q, k, v,
                                                        causal=True)[0]),
}

# (custom_white_list, custom_black_list): a black op and a norm op made
# white, and white, norm and unlisted ops made black
CUSTOM = {"white": ({"softmax", "layer_norm", "gelu"}, None),
          "black": (None, {"linear", "matmul_v2", "layer_norm", "gelu",
                           "batch_norm", "conv2d"})}


def _inputs(spec, low, seed):
    """The same inputs for both packages: (reference tensors, port
    tensors); floats in float32, or in ``low`` when given."""
    rng = np.random.default_rng(seed)
    jx, tx = [], []
    for kind, *rest in spec:
        if kind == "i":
            high, shape = rest
            a = rng.integers(0, high, shape)
            jx.append(paddle.to_tensor(a.astype(np.int32)))
            tx.append(torch.from_numpy(a))
            continue
        (shape,) = rest
        a = rng.standard_normal(shape).astype(np.float32)
        if kind == "pos":
            a = np.abs(a) + 0.5
        j, t = paddle.to_tensor(a), torch.from_numpy(a)
        if low is not None:
            j, t = j.astype(low), t.to(getattr(torch, low))
        jx.append(j)
        tx.append(t)
    return jx, tx


def _out_dtypes(op, level, dtype, variant):
    spec, jcall, tcall = OPS[op]
    white, black = CUSTOM.get(variant, (None, None))
    jx, tx = _inputs(spec, dtype if variant == "low" else None,
                     seed=len(op))
    kw = dict(level=level, dtype=dtype, custom_white_list=white,
              custom_black_list=black)
    with jamp.auto_cast(**kw):
        jout = jcall(*jx)
    with amp.auto_cast(**kw):
        tout = tcall(*tx)
    return _name(jout.dtype), _name(tout.dtype)


@pytest.mark.parametrize("variant", ["float32", "low", "white", "black"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", list(OPS))
def test_op_output_dtype_matches_jax(op, level, dtype, variant):
    """Under ``auto_cast`` each port op gives the output type the
    reference's gives on the same inputs: float32 inputs, inputs already
    in the low type (black ops take them back to float32), and custom
    white and black lists."""
    ref, got = _out_dtypes(op, level, dtype, variant)
    assert got == ref


def test_lists_equal_the_reference_and_amp_off_is_a_no_op():
    assert amp.WHITE_LIST == jamp.WHITE_LIST
    assert amp.BLACK_LIST == jamp.BLACK_LIST
    assert amp.NORM_OPS == jamp.NORM_OPS
    x = torch.ones(2, 2)
    assert not amp.is_auto_cast_enabled()
    out = amp.cast_inputs("linear", x, None)
    assert out[0] is x and out[1] is None


def test_o1_cast_keeps_float32_weight_gradients():
    """The cast is differentiable: a float32 weight that an O1 linear
    reads in bfloat16 gets its gradient in float32, as the reference's
    amp_cast gives it."""
    rng = np.random.default_rng(0)
    x, w = (rng.standard_normal(s).astype(np.float32) for s in ((4, 8),
                                                                 (8, 3)))
    jw = paddle.to_tensor(w, stop_gradient=False)
    tw = torch.from_numpy(w).requires_grad_()
    with jamp.auto_cast():
        jy = JF.linear(paddle.to_tensor(x), jw)
    with amp.auto_cast():
        ty = F.linear(torch.from_numpy(x), tw)
    assert _name(jy.dtype) == _name(ty.dtype) == "bfloat16"
    jy.astype("float32").sum().backward()
    ty.float().sum().backward()
    assert _name(jw.grad.dtype) == _name(tw.grad.dtype) == "float32"
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw.grad._data),
                               rtol=0, atol=TOL)


# -- (b) the small GPT under O1 bfloat16 --------------------------------------

def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (4, 32)).astype(
        np.int32)


def _sched(pkg):
    return pkg.lr.LinearWarmup(pkg.lr.CosineAnnealingDecay(1e-3, 20), 3,
                               1e-4, 1e-3)


def _jax_model(impl, multi_precision=False, o2=False, sched=True):
    """A JAX paddle.Model with AdamW (decay 0.01, warmup+cosine), built
    inside ``auto_cast`` by the caller so its compiled step traces under
    AMP, and its initial float32 weights."""
    paddle.seed(0)
    net = JGPT(JGPTConfig(**FLAGSHIP, attn_impl=impl))
    arrays = {k: np.array(v._data) for k, v in net.state_dict().items()}
    if o2:
        jamp.decorate(net, level="O2")
    lr = _sched(jopt) if sched else 1e-3
    opt = jopt.AdamW(learning_rate=lr, parameters=net.parameters(),
                     epsilon=EPS, weight_decay=0.01,
                     multi_precision=multi_precision)
    model = paddle.Model(net)
    model.prepare(opt, JCrit())
    return model, net, lr, arrays


def _port_model(impl, arrays, multi_precision=False, o2=False, sched=True):
    net = GPTForCausalLM(GPTConfig(**FLAGSHIP, attn_impl=impl), device="cpu",
                         seed=1)
    net.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    if o2:
        assert amp.decorate(net, level="O2") is net
    lr = _sched(topt) if sched else 1e-3
    opt = topt.AdamW(learning_rate=lr, parameters=net.parameters(),
                     epsilon=EPS, weight_decay=0.01,
                     multi_precision=multi_precision, device="cpu")
    model = P.Model(net, device="cpu")
    model.prepare(opt, GPTPretrainingCriterion())
    return model, net, lr


def _grads(named):
    return {n: np.asarray(g, np.float32) for n, g in named}


@pytest.fixture(scope="module", params=["dense", "flash"])
def o1_reference(request):
    """The JAX side under O1 bfloat16, once per attention impl: logits,
    step-1 gradients and the 10-step loss curve; and the step-1 gradients
    without AMP."""
    impl = request.param
    model, net, _, _ = _jax_model(impl)
    ids = _ids()
    model.train_batch([ids], [ids], update=False)
    grads_f32 = _grads((n, p._grad) for n, p in net.named_parameters())
    saved = dict(jamp._STATE)
    try:
        with jamp.auto_cast():
            model, net, sched, arrays = _jax_model(impl)
            ids = _ids()
            logits = np.asarray(net(paddle.to_tensor(ids))._data, np.float32)
            model.train_batch([ids], [ids], update=False)
            grads = _grads((n, p._grad) for n, p in net.named_parameters())
            model._optimizer.clear_grad()
            losses = []
            for _ in range(10):
                losses.append(model.train_batch([ids], [ids])[0])
                sched.step()
    finally:
        jamp._STATE.update(saved)
    return dict(impl=impl, arrays=arrays, logits=logits, grads=grads,
                grads_f32=grads_f32, losses=losses)


def test_o1_logits_match_jax(o1_reference):
    model, net, _ = _port_model(o1_reference["impl"],
                                o1_reference["arrays"])
    with amp.auto_cast():
        logits = net(torch.from_numpy(_ids()))
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().detach().numpy(),
                               o1_reference["logits"], rtol=0, atol=TOL)


def test_o1_step1_gradients_match_jax(o1_reference):
    """Gradients in float32 on the float32 weights, each within 2e-2 of
    its tensor's largest (k_proj.bias: zero but for rounding, as softmax
    ignores a score shift shared by all keys).

    The biases of the bfloat16 linears are held to the reference's
    gradients without AMP instead: JAX's transpose of the broadcast bias
    add is a reduce_sum in bfloat16, which leaves the reference's bias
    gradients 2-4% of their max from float32, where torch sums in float32
    and the port's stay within 1.5% (the weights' gradients of both
    packages are within 1.4% of float32)."""
    model, net, _ = _port_model(o1_reference["impl"],
                                o1_reference["arrays"])
    ids = _ids()
    with amp.auto_cast():
        model.train_batch([ids], [ids], update=False)
    ref = o1_reference["grads"]
    top = max(np.abs(g).max() for g in ref.values())
    for n, p in net.named_parameters():
        assert p.grad.dtype == torch.float32, n
        if n.endswith("k_proj.bias"):
            assert float(p.grad.abs().max()) < TOL * top
            continue
        want = ref[n]
        if n.endswith(".bias") and "norm" not in n:
            want = o1_reference["grads_f32"][n]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=n)


def test_o1_ten_step_loss_curve_matches_jax(o1_reference):
    model, net, sched = _port_model(o1_reference["impl"],
                                    o1_reference["arrays"])
    ids = _ids()
    losses = []
    with amp.auto_cast():
        for _ in range(10):
            losses.append(model.train_batch([ids], [ids])[0])
            sched.step()
    np.testing.assert_allclose(losses, o1_reference["losses"], rtol=0,
                               atol=TOL)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in net.parameters())


# -- (c) O2 with decorate ------------------------------------------------------

@pytest.mark.parametrize("multi_precision", [True, False])
def test_o2_decorate_matches_jax(multi_precision):
    """decorate(level="O2") casts every parameter to bfloat16 in both
    packages; 5 AdamW steps under auto_cast(level="O2") give the same
    losses. With multi_precision the float32 masters keep the parameters
    in bfloat16 in both. Without, the reference's update promotes them to
    float32 at its first step (its float32 step counter enters the update)
    while the port's stay bfloat16: a deliberate difference (ROADMAP.md)."""
    ids = _ids()
    with jamp.auto_cast(level="O2"):
        jm, jnet, _, arrays = _jax_model("dense", multi_precision, o2=True,
                                         sched=False)
        jtypes = {n: _name(p.dtype) for n, p in jnet.named_parameters()}
        jl = [jm.train_batch([ids], [ids])[0] for _ in range(5)]
    tm, tnet, _ = _port_model("dense", arrays, multi_precision, o2=True,
                              sched=False)
    assert {n: _name(p.dtype) for n, p in tnet.named_parameters()} \
        == jtypes == {n: "bfloat16" for n in jtypes}
    with amp.auto_cast(level="O2"):
        tl = [tm.train_batch([ids], [ids])[0] for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    assert tl[-1] < tl[0]
    after = {_name(p.dtype) for p in jnet.parameters()}
    assert {_name(p.dtype) for p in tnet.parameters()} == {"bfloat16"}
    assert after == ({"bfloat16"} if multi_precision else {"float32"})


def test_decorate_returns_the_optimizers_unchanged():
    net = torch.nn.Linear(2, 2)
    opt = topt.SGD(parameters=net.parameters(), device="cpu")
    out_net, out_opt = amp.decorate(net, opt, level="O2", dtype="float16")
    assert out_net is net and out_opt is opt
    assert net.weight.dtype == torch.float16
    assert amp.decorate([net], level="O1") == [net]
    assert net.weight.dtype == torch.float16


# -- (d) GradScaler with float16 ----------------------------------------------

def _classifier_weights():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(np.float32) * 0.5
            for s in ((8, 16), (16,), (16, 5), (5,))]


class _TNet(torch.nn.Module):
    def __init__(self, ws):
        super().__init__()
        self.l1 = P.nn.Linear(8, 16, device="cpu")
        self.l2 = P.nn.Linear(16, 5, device="cpu")
        with torch.no_grad():
            for p, w in zip((self.l1.weight, self.l1.bias, self.l2.weight,
                             self.l2.bias), ws):
                p.copy_(torch.from_numpy(w))

    def forward(self, x):
        return self.l2(F.gelu(self.l1(x)))


def _jnet(ws):
    jnn = paddle.nn
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(), jnn.Linear(16, 5))
    for p, w in zip(net.parameters(), ws):
        p.set_value(w)
    return net


def _scaler_run(pkg, steps, init_scale):
    """The eager float16 recipe: forward and loss under
    auto_cast(dtype="float16"), then scale, backward, step, update; step
    4's input holds an inf. Returns each step's (scale after update,
    found inf) and the scaler."""
    ws = _classifier_weights()
    rng = np.random.default_rng(5)
    kw = dict(init_loss_scaling=init_scale, incr_every_n_steps=2)
    if pkg == "jax":
        net = _jnet(ws)
        opt = jopt.SGD(learning_rate=0.1, parameters=net.parameters())
        scaler, cast, crit = jamp.GradScaler(**kw), jamp.auto_cast, JF
        tensor = paddle.to_tensor
    else:
        net = _TNet(ws)
        opt = topt.SGD(learning_rate=0.1, parameters=net.parameters(),
                       device="cpu")
        scaler, cast, crit = amp.GradScaler(**kw), amp.auto_cast, F
        tensor = torch.from_numpy
    out = []
    for step in range(steps):
        x = rng.standard_normal((8, 8)).astype(np.float32)
        y = rng.integers(0, 5, 8)
        if step == 3:
            x[0, 0] = np.inf
        with cast(dtype="float16"):
            loss = crit.cross_entropy(net(tensor(x)), tensor(y))
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.step(opt)
        found = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        out.append((scaler._scale, found))
    return out, scaler


@pytest.mark.parametrize("init_scale", [2.0 ** 15, 2.0 ** 22])
def test_grad_scaler_scales_and_skips_match_jax(init_scale):
    """The scale after every step and the skipped steps are equal: a
    growth every 2 finite steps, a halving at the injected inf (step 4)
    and, from 2^22, at the float16 overflows of the first steps."""
    ref, _ = _scaler_run("jax", 8, init_scale)
    got, scaler = _scaler_run("port", 8, init_scale)
    assert got == ref
    assert ref[3][1] is True
    assert scaler.found_inf_steps == sum(f for _, f in ref)
    assert scaler.loss_scale == ref[-1][0]


def test_grad_scaler_minimize_unscale_twice_and_state_dict():
    ws = _classifier_weights()
    x = torch.from_numpy(np.ones((2, 8), np.float32))
    net = _TNet(ws)
    opt = topt.SGD(learning_rate=0.1, parameters=net.parameters(),
                   device="cpu")
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    with amp.auto_cast(dtype="float16"):
        loss = F.cross_entropy(net(x), torch.tensor([1, 2]))
    w0 = net.l1.weight.detach().clone()
    scaler.minimize(opt, scaler.scale(loss))       # backward, step, update
    assert not torch.equal(net.l1.weight, w0)
    with amp.auto_cast(dtype="float16"):
        loss = F.cross_entropy(net(x), torch.tensor([1, 2]))
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.unscale_(opt)
    # the reference raises the same way
    jnet = _jnet(ws)
    jopt_ = jopt.SGD(learning_rate=0.1, parameters=jnet.parameters())
    jscaler = jamp.GradScaler(init_loss_scaling=8.0)
    with jamp.auto_cast(dtype="float16"):
        jloss = JF.cross_entropy(jnet(paddle.to_tensor(x.numpy())),
                                 paddle.to_tensor(np.array([1, 2])))
    jscaler.scale(jloss).backward()
    jscaler.unscale_(jopt_)
    with pytest.raises(RuntimeError, match="already been called"):
        jscaler.unscale_(jopt_)
    # state dicts move both ways
    _, jsc = _scaler_run("jax", 5, 2.0 ** 15)
    _, tsc = _scaler_run("port", 5, 2.0 ** 15)
    fresh = amp.GradScaler()
    fresh.load_state_dict(jsc.state_dict())
    assert fresh.state_dict() == jsc.state_dict() == tsc.state_dict()
    jfresh = jamp.GradScaler(init_loss_scaling=1.0)
    jfresh.load_state_dict(tsc.state_dict())
    assert jfresh.state_dict() == tsc.state_dict()
    assert set(tsc.state_dict()) >= {"good_steps", "bad_steps", "incr_count",
                                     "decr_count"}
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    assert amp.AmpScaler is amp.GradScaler


# -- (e) the rest of the API ---------------------------------------------------

def test_state_api_and_nesting_match_jax():
    def state(pkg):
        d = pkg.get_amp_dtype()
        return pkg.is_auto_cast_enabled(), None if d is None else _name(d)

    seen = {}
    for name, pkg in (("jax", jamp), ("port", amp)):
        trace = [state(pkg)]
        with pkg.auto_cast(dtype="float16"):
            trace.append(state(pkg))
            with pkg.amp_guard(enable=False):
                trace.append(state(pkg))
            with pkg.auto_cast(level="O2"):
                trace.append((state(pkg), pkg._STATE["level"]))
            trace.append(state(pkg))
        trace.append(state(pkg))
        pkg.enable_operator_amp(level="O2", dtype="float16")
        trace.append((state(pkg), pkg._STATE["level"]))
        pkg.disable_operator_amp()
        trace.append(state(pkg))
        seen[name] = trace
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == (True, "float16")
    assert seen["port"][2] == (False, "bfloat16")


def test_enable_operator_amp_casts_without_a_block():
    x = torch.ones(2, 3)
    w = torch.ones(3, 4)
    amp.enable_operator_amp()
    assert F.linear(x, w).dtype == torch.bfloat16
    amp.disable_operator_amp()
    assert F.linear(x, w).dtype == torch.float32


# -- (f) the deliberate differences -------------------------------------------

def test_decorate_refuses_what_it_would_ignore():
    """The reference accepts master_weight and save_dtype and never reads
    them; the port raises, naming what to use instead."""
    net = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="multi_precision"):
        amp.decorate(net, level="O2", master_weight=True)
    with pytest.raises(ValueError, match="multi_precision"):
        amp.decorate(net, level="O2", master_weight=False)
    with pytest.raises(ValueError, match="save_dtype"):
        amp.decorate(net, level="O2", save_dtype="float32")
    assert net.weight.dtype == torch.float32
    jnet = paddle.nn.Linear(2, 2)
    jamp.decorate(jnet, level="O2", master_weight=True, save_dtype="float32")


def test_o2_tensor_operators_are_not_cast():
    """At O2 the reference casts the inputs of tensor operators too
    (elementwise_add of float32 and bfloat16 gives bfloat16); the port's
    operators do not consult the hook (float32). On the GPT path every
    such operand is already bfloat16 at O2, because decorate casts the
    parameters (test_o2_decorate_matches_jax)."""
    a = np.ones((2, 2), np.float32)
    with jamp.auto_cast(level="O2"):
        jout = paddle.to_tensor(a) + paddle.to_tensor(a).astype("bfloat16")
    with amp.auto_cast(level="O2"):
        tout = torch.from_numpy(a) + torch.from_numpy(a).bfloat16()
    assert _name(jout.dtype) == "bfloat16"
    assert tout.dtype == torch.float32
