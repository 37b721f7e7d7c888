"""The port's compiled training contract against the JAX package's
(``paddle_tpu/hapi/model.py``; the cases of ``tests/test_train_multi_step.py``
and ``tests/test_yolov3_e2e.py::test_bucketed_multiscale_no_recompile``),
on the CPU: ``Model.train_batch`` runs one compiled step program per input
signature and AMP state (on the CPU its static-buffer program runs
eagerly and counts a trace at the signature's first call; the captured
CUDA graphs are held on the card in ``tests/test_torch_cuda.py``),
``train_batches`` replays it K times, and ``train_loop`` replays one
program over coalesced flat buffers. Both equal K ``train_batch`` calls
and the JAX package's own ``train_batches``/``train_loop`` on the same
numpy inputs: losses at 1e-4, parameters, optimizer state and BatchNorm
running statistics at 1e-5 (the reference test's tolerances)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.core.tensor import Tensor  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainingCriterion as JCrit  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.core import graphs  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import functional as F  # noqa: E402

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
K = 4


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(K, 8, 8).astype(np.float32),
            rng.randint(0, 4, (K, 8)).astype(np.int64))


def _jax_net():
    """The reference test's net: Linear, BatchNorm1D, ReLU, Linear; the
    first Linear without a bias, which the BatchNorm would cancel: its
    gradient is zero up to rounding, and Adam (eps 1e-8) moves such a
    weight by a rounding-driven fraction of lr, differently per package
    (as ``k_proj.bias`` in tests/test_torch_hapi_train.py)."""
    paddle.seed(7)
    return paddle.nn.Sequential(
        paddle.nn.Linear(8, 16, bias_attr=False), paddle.nn.BatchNorm1D(16),
        paddle.nn.ReLU(), paddle.nn.Linear(16, 4))


def _arrays():
    return {k: np.array(v._data) for k, v in _jax_net().state_dict().items()}


def _port_net(arrays):
    net = P.nn.Sequential(P.nn.Linear(8, 16, bias=False, device="cpu"),
                          P.nn.BatchNorm1D(16, device="cpu"),
                          torch.nn.ReLU(), P.nn.Linear(16, 4, device="cpu"))
    net.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    return net


def _opt(pkg, kind, params, clip_cls=None):
    """The reference test's optimizers (Momentum with coupled decay and a
    global-norm clip; AdamW with apply_decay_param_fun), and AdamW with an
    lr_ratio too, so the flat update meets several settings."""
    kw = {} if pkg is jopt else {"device": "cpu"}
    clip = getattr(_pkg_nn(pkg), clip_cls or "ClipGradByGlobalNorm")
    if kind == "momentum":
        return pkg.Momentum(learning_rate=1e-2, momentum=0.9,
                            parameters=params, weight_decay=1e-3,
                            grad_clip=clip(0.5), **kw)
    if kind == "adamw":
        return pkg.AdamW(learning_rate=1e-2, parameters=params,
                         weight_decay=0.05,
                         apply_decay_param_fun=lambda n: "weight" in n,
                         **kw)
    if kind == "adamw_ratio":
        return pkg.AdamW(learning_rate=1e-2, parameters=params,
                         weight_decay=0.05, grad_clip=clip(0.5),
                         lr_ratio=lambda p: 0.5 if len(p.shape) == 1
                         else 1.0, **kw)
    return pkg.Adam(learning_rate=1e-2, parameters=params, **kw)


def _pkg_nn(pkg):
    return paddle.nn if pkg is jopt else P.nn


def _ce(logits, label):
    return F.cross_entropy(logits, label)


def _port_model(kind, arrays, named=True, clip_cls=None):
    net = _port_net(arrays)
    params = list(net.named_parameters()) if named else net.parameters()
    m = P.Model(net, device="cpu")
    m.prepare(_opt(topt, kind, params, clip_cls), _ce)
    return m, net


def _jax_model(kind):
    net = _jax_net()
    m = paddle.Model(net)
    m.prepare(_opt(jopt, kind, net.parameters()),
              paddle.nn.CrossEntropyLoss())
    return m, net


def _port_steps(m, xs, ys):
    return [m.train_batch([xs[k]], [ys[k]])[0] for k in range(len(xs))]


def _assert_state_equal(net1, net2, opt1=None, opt2=None):
    s1, s2 = net1.state_dict(), net2.state_dict()
    assert sorted(s1) == sorted(s2)
    for k in s1:
        np.testing.assert_allclose(s1[k].numpy(), s2[k].numpy(),
                                   err_msg=k, **STATE_TOL)
    if opt1 is not None:
        o1, o2 = opt1.state_dict(), opt2.state_dict()
        assert sorted(o1) == sorted(o2)
        for k in o1:
            if isinstance(o1[k], torch.Tensor):
                np.testing.assert_allclose(o1[k].numpy(), o2[k].numpy(),
                                           err_msg=k, **STATE_TOL)
            else:
                assert o1[k] == o2[k], k


def _assert_matches_jax(tnet, jnet):
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(tnet.state_dict()[k].numpy(),
                                   np.asarray(v._data), err_msg=k,
                                   **STATE_TOL)


# -- train_batches and train_loop equal K train_batch calls -----------------

@pytest.mark.parametrize("method", ["train_batches", "train_loop"])
@pytest.mark.parametrize("kind", ["momentum", "adamw", "adamw_ratio"])
def test_multi_step_equals_k_train_batch_calls(kind, method):
    xs, ys = _data()
    arrays = _arrays()
    m1, net1 = _port_model(kind, arrays)
    ref = _port_steps(m1, xs, ys)
    m2, net2 = _port_model(kind, arrays)
    got = getattr(m2, method)([xs], [ys])
    if method == "train_loop":
        assert m2._fused_loop is not None, "the fused path must engage"
        assert all(p.grad is None for p in net2.parameters())
    np.testing.assert_allclose(got, ref, **LOSS_TOL)
    _assert_state_equal(net1, net2, m1._optimizer, m2._optimizer)
    assert m2._optimizer._global_step == K
    # the BatchNorm running statistics moved, as K steps move them
    assert not np.allclose(net2.state_dict()["1._mean"].numpy(),
                           arrays["1._mean"])


@pytest.mark.parametrize("method", ["train_batches", "train_loop"])
@pytest.mark.parametrize("kind", ["momentum", "adamw", "adamw_ratio"])
def test_multi_step_matches_jax(kind, method):
    """The port's train_batches/train_loop against the JAX package's own
    (its lax.scan and its coalesced loop). The JAX package names its
    parameters "" for apply_decay_param_fun, so the port passes bare
    parameters here too."""
    xs, ys = _data()
    jm, jnet = _jax_model(kind)
    jl = getattr(jm, method)([paddle.to_tensor(xs)], [paddle.to_tensor(ys)])
    arrays = {k: np.array(v) for k, v in _arrays().items()}
    tm, tnet = _port_model(kind, arrays, named=False)
    tl = getattr(tm, method)([torch.from_numpy(xs)], [torch.from_numpy(ys)])
    np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_matches_jax(tnet, jnet)
    jstate = jm._optimizer.state_dict()
    tstate = tm._optimizer.state_dict()
    assert tstate["global_step"] == jstate["global_step"] == K
    for k, v in tstate.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_allclose(v.numpy(), np.asarray(
                jstate[k]._data if isinstance(jstate[k], Tensor)
                else jstate[k]), err_msg=k, **STATE_TOL)


def test_train_loop_falls_back_for_a_per_parameter_norm_clip():
    """ClipGradByNorm scales each gradient by its own norm: not
    elementwise on a flat buffer, so the loop runs per-step train_batch
    (the reference's fallback; Lamb, its other case, is not ported)."""
    xs, ys = _data()
    arrays = _arrays()
    m1, net1 = _port_model("momentum", arrays, clip_cls="ClipGradByNorm")
    ref = _port_steps(m1, xs, ys)
    m2, net2 = _port_model("momentum", arrays, clip_cls="ClipGradByNorm")
    got = m2.train_loop([xs], [ys])
    assert m2._fused_loop is None
    np.testing.assert_allclose(got, ref, **LOSS_TOL)
    _assert_state_equal(net1, net2, m1._optimizer, m2._optimizer)


def test_train_loop_keeps_training_where_train_batch_left_off():
    """A train_batch, then a train_loop (which packs the parameters and
    state into flat buffers and retires the step program that read their
    old places), then train_batch again (a new trace over the flat
    views), against the same steps through train_batch alone."""
    xs, ys = _data()
    arrays = _arrays()
    m1, net1 = _port_model("adamw", arrays)
    ref = _port_steps(m1, xs, ys) + _port_steps(m1, xs, ys)
    m2, net2 = _port_model("adamw", arrays)
    got = [m2.train_batch([xs[0]], [ys[0]])[0]]
    got += m2.train_loop([xs[1:]], [ys[1:]])
    got += m2.train_loop([xs[:2]], [ys[:2]])      # no second packing
    got += [m2.train_batch([xs[k]], [ys[k]])[0] for k in (2, 3)]
    np.testing.assert_allclose(got, ref, **LOSS_TOL)
    _assert_state_equal(net1, net2, m1._optimizer, m2._optimizer)
    ts = m2._train_step_fn
    assert ts["fn"].trace_counter["traces"] == 2
    assert m2._fused_loop["fn"].trace_counter["traces"] == 1
    flat = m2._fused_loop["layout"]
    assert sum(n for _, _, n in flat) == sum(p.numel()
                                             for p in net2.parameters())


def test_multi_step_refuses_pending_accumulated_gradients():
    xs, ys = _data()
    m, _ = _port_model("momentum", _arrays())
    m.train_batch([xs[0]], [ys[0]], update=False)
    with pytest.raises(RuntimeError, match="pending accumulated"):
        m.train_batches([xs], [ys])
    with pytest.raises(RuntimeError, match="pending accumulated"):
        m.train_loop([xs], [ys])


def test_prepare_and_load_invalidate_the_compiled_steps(tmp_path):
    """prepare(new optimizer) drops the compiled step and loop (they hold
    the old rule and its state) and the new optimizer's state is written
    with its own keys; load() drops them too and the next step traces
    anew on the loaded weights."""
    xs, ys = _data()

    def run(use_loop):
        m, net = _port_model("momentum", _arrays())
        opt1 = m._optimizer
        if use_loop:
            m.train_loop([xs], [ys])
        else:
            _port_steps(m, xs, ys)
        assert m._train_fns
        opt2 = topt.Adam(learning_rate=1e-2, parameters=net.parameters(),
                         device="cpu")
        m.prepare(opt2, _ce)
        assert not m._train_fns and m._fused_loop is None \
            and m._train_step_fn is None
        if use_loop:
            losses = m.train_loop([xs], [ys])
            assert m._fused_loop is not None, "the fused path must re-engage"
        else:
            losses = _port_steps(m, xs, ys)
        assert set(opt2._state[0]) == {"moment1", "moment2"}
        assert float(opt2._state[0]["moment2"].abs().sum()) > 0
        assert opt2._global_step == K and opt1._global_step == K
        return losses, m, net

    ref, _, _ = run(False)
    got, m, net = run(True)
    np.testing.assert_allclose(ref, got, **LOSS_TOL)
    path = str(tmp_path / "ckpt")
    m.save(path)
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    after = m.train_batch([xs[0]], [ys[0]])[0]
    m.load(path)
    assert not m._train_fns and m._fused_loop is None
    for k, v in net.state_dict().items():
        assert torch.equal(v, saved[k]), k
    again = m.train_batch([xs[0]], [ys[0]])[0]
    assert m._train_step_fn["fn"].trace_counter["traces"] == 1
    assert again == after


def test_one_trace_per_signature_and_switching_back_replays():
    """Two input shapes give two programs; switching back and forth
    builds and traces nothing new (the reference's bucketed multi-scale
    YOLOv3 training, tests/test_yolov3_e2e.py:77-93)."""
    m, _ = _port_model("momentum", _arrays())
    builds = []
    orig = m._build_train_step

    def counting(sig):
        builds.append(sig)
        return orig(sig)

    m._build_train_step = counting
    rng = np.random.RandomState(1)
    batches = {n: (rng.randn(n, 8).astype(np.float32),
                   rng.randint(0, 4, n).astype(np.int64)) for n in (8, 12)}
    for step in range(6):
        x, y = batches[(8, 12)[step % 2]]
        assert np.isfinite(m.train_batch([x], [y])[0])
    assert len(builds) == 2 and len(m._train_fns) == 2
    assert [ts["fn"].trace_counter["traces"]
            for ts in m._train_fns.values()] == [1, 1]
    # the eager lane runs the same function and counts no trace
    with graphs.disable_graphs():
        m.train_batch([batches[8][0]], [batches[8][1]])
    assert [ts["fn"].trace_counter["traces"]
            for ts in m._train_fns.values()] == [1, 1]


def test_the_amp_state_is_part_of_the_signature():
    """A step traced outside auto_cast is not replayed inside it: the AMP
    state keys a program of its own, whose loss is the bf16 one."""
    ids = np.random.RandomState(0).randint(0, 256, (4, 32)).astype(np.int32)
    losses = {}
    for key in ("fp32", "bf16"):
        net = GPTForCausalLM(GPTConfig(**FLAGSHIP), device="cpu", seed=0)
        m = P.Model(net, device="cpu")
        m.prepare(topt.SGD(learning_rate=0.0, parameters=net.parameters(),
                           device="cpu"), GPTPretrainingCriterion())
        if key == "fp32":
            losses[key] = m.train_batch([ids], [ids])[0]
            with amp.auto_cast():
                losses["fp32_then_bf16"] = m.train_batch([ids], [ids])[0]
            assert len(m._train_fns) == 2
            assert [sig[2] for sig in m._train_fns] == [
                (False,), (True, "torch.bfloat16", "O1", (), ())]
        else:
            with amp.auto_cast():
                losses[key] = m.train_batch([ids], [ids])[0]
    assert losses["fp32_then_bf16"] == losses["bf16"]
    assert losses["fp32"] != losses["bf16"]
    assert abs(losses["fp32"] - losses["bf16"]) < 2e-2


# -- the slice as a whole: the flagship GPT's curve against the JAX package --

FLAGSHIP = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                intermediate_size=512, max_position_embeddings=32,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
EPS = 1e-6   # see tests/test_torch_hapi_train.py: k_proj.bias's zero grad


@pytest.fixture(scope="module")
def jax_curve():
    """The JAX package's jitted train_batch: 10 AdamW steps (decay 0.01,
    global-norm clip 1.0, constant lr) of the flagship GPT, flash
    attention, on one batch; its initial weights."""
    paddle.seed(0)
    net = JGPT(JGPTConfig(**FLAGSHIP, attn_impl="flash"))
    arrays = {k: np.array(v._data) for k, v in net.state_dict().items()}
    m = paddle.Model(net)
    m.prepare(jopt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         epsilon=EPS, weight_decay=0.01,
                         grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)),
              JCrit())
    ids = np.random.RandomState(0).randint(0, 256, (4, 32)).astype(np.int32)
    losses = [m.train_batch([ids], [ids])[0] for _ in range(10)]
    params = {k: np.array(v._data) for k, v in net.state_dict().items()}
    return arrays, ids, losses, params


@pytest.mark.parametrize("method", ["train_batch", "train_batches",
                                    "train_loop"])
def test_flagship_gpt_curve_matches_jax(jax_curve, method):
    arrays, ids, ref, ref_params = jax_curve
    net = GPTForCausalLM(GPTConfig(**FLAGSHIP, attn_impl="flash"),
                         device="cpu", seed=1)
    net.load_state_dict(P.state_dict_from_reference(arrays, "cpu"))
    m = P.Model(net, device="cpu")
    m.prepare(topt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         epsilon=EPS, weight_decay=0.01,
                         grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                         device="cpu"), GPTPretrainingCriterion())
    if method == "train_batch":
        losses = [m.train_batch([ids], [ids])[0] for _ in range(10)]
        assert m._train_step_fn["fn"].trace_counter["traces"] == 1
    else:
        stack = np.stack([ids] * 10)
        losses = getattr(m, method)([stack], [stack])
    if method == "train_loop":
        assert m._fused_loop is not None
    np.testing.assert_allclose(losses, ref, rtol=0, atol=1e-4)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_params[k], rtol=0,
                                   atol=1e-5, err_msg=k)


# -- BatchNorm1D, the reference test's layer ---------------------------------

def test_batchnorm1d_matches_jax():
    rng = np.random.default_rng(4)
    jbn = paddle.nn.BatchNorm1D(6)
    tbn = P.nn.BatchNorm1D(6, device="cpu")
    for shape in ((5, 6), (5, 6, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        jbn.train()
        tbn.train()
        jy = np.asarray(jbn(paddle.to_tensor(x))._data)
        ty = tbn(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tbn, name).numpy(),
                np.asarray(getattr(jbn, name)._data), rtol=1e-5, atol=1e-5)
        jbn.eval()
        tbn.eval()
        np.testing.assert_allclose(
            tbn(torch.from_numpy(x)).detach().numpy(),
            np.asarray(jbn(paddle.to_tensor(x))._data), rtol=1e-5,
            atol=1e-5)
