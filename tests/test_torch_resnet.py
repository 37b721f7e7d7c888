"""ResNet, LeNet and VGG of the port against the JAX package's, weights
carried by ``state_dict_from_reference``, at bench.py's CPU shape
(4x3x32x32, here with 10 classes) and its optimizer (Momentum 0.9,
coupled weight decay 1e-4, ``CrossEntropyLoss`` on ``[B]`` int64 labels).

Float32 parity of a train-mode step is bounded at this shape by the
problem, not by either package: the last stages normalise 4 values per
channel (1x1 maps of 4 images), so train-mode BatchNorm amplifies
rounding, and the gradients of convolutions before BN and of biases whose
gradient is zero in exact arithmetic (every channel sum of a BN input's
gradient vanishes) are mostly cancellation. Measured by this file's
``_measure`` (``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_resnet.py``): ResNet-50's float32 step-1 gradients lie
3.6% (the JAX package) and 4.4% (the port) of the largest gradient from
a float64 run of the same weights, ResNet-18's 1.6e-4 and 7.8e-5; the
two packages' float32 curves part by 7-26% at step 2 (lr 1e-4 to 0.01).
So the train-mode step is held in float64 in both packages
(``jax_enable_x64`` around the JAX side, then restored): ResNet-18's
step-1 gradients and BN statistics and its 10-step ``Model.train_batch``
Momentum curve at lr 0.01 with the weights and statistics after it,
ResNet-50's step-1 gradients and statistics and bench.py's lr 0.1 over 3
steps (2.55 -> 53.77 -> 80.21), where gradients agree to 5e-11 of the
largest, statistics to 4e-13 and the curves to 9e-10 (ResNet-18) and
8e-8. ResNet-50's lr-0.01 curve is chaotic at this shape even in
float64 (9.2e-8 apart at step 3, 9.2e-5 at step 4, 8.5e-3 at step 5),
so it is not a test. In float32: eval-mode forwards
(on statistics a train-mode pass moved) at 1e-5, that pass's loss and
statistics at 1e-5 (ResNet-18) and 1e-3 and 1e-4 (ResNet-50: 3.2e-4
and 8.8e-5 measured), ``train_loop`` bitwise equal to ``train_batch``,
and under O1 bfloat16 the type of every stage's output equal to the JAX
package's, the first loss within 2e-2 (1.5e-2 measured) and 3 steps
finite with float32 weights (bfloat16 rounding meets the same
amplification: the second O1 losses part by 57%). LeNet and VGG-11's
features with and without BN (in eval; a 2x2 map pooled into 7x7
overlapping bins) hold forward and gradients at 1e-5 in float32."""
import contextlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.vision import models as jmodels  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.ops.manipulation import flatten  # noqa: E402
from paddle_tpu_torch.vision import models as tmodels  # noqa: E402

TOL = 1e-5            # float32 forwards
F64_TOL = 1e-9        # float64: gradients (of the largest), statistics
CURVE_TOL = 1e-4      # float64 loss curves, relative
AMP_TOL = 2e-2
BATCH = (4, 3, 32, 32)
CLASSES = 10


def _batch(dtype=np.float32):
    rng = np.random.RandomState(0)
    x = rng.rand(*BATCH).astype(dtype)
    y = rng.randint(0, CLASSES, (BATCH[0],)).astype(np.int64)
    return x, y


@contextlib.contextmanager
def _jax_float64():
    """The JAX package in float64 inside (x64 on), restored after."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _arrays(jnet):
    return {k: np.array(v._data) for k, v in jnet.state_dict().items()}


def _carry(arrays, tnet):
    tnet.load_state_dict(P.state_dict_from_reference(arrays, "cpu"),
                         strict=True)
    return tnet


def _jax_resnet(depth):
    paddle.seed(0)
    return getattr(jmodels, f"resnet{depth}")(num_classes=CLASSES)


def _port_resnet(depth, arrays):
    return _carry(arrays, getattr(tmodels, f"resnet{depth}")(
        num_classes=CLASSES, device="cpu", seed=None))


def _jax_model(jnet, lr):
    opt = jopt.Momentum(learning_rate=lr, momentum=0.9,
                        parameters=jnet.parameters(), weight_decay=1e-4)
    m = paddle.Model(jnet)
    m.prepare(opt, jnn.CrossEntropyLoss())
    return m


def _port_model(tnet, lr):
    opt = topt.Momentum(learning_rate=lr, momentum=0.9,
                        parameters=tnet.parameters(), weight_decay=1e-4,
                        device="cpu")
    m = P.Model(tnet, device="cpu")
    m.prepare(opt, tnn.CrossEntropyLoss())
    return m


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / np.abs(want)).max())


# -- architecture -------------------------------------------------------------

def test_resnet50_parameter_count():
    """25,557,032 parameters, counted as tests/test_vision.py counts the
    JAX package's (torchvision's ResNet-50 has the same)."""
    net = tmodels.resnet50(device="cpu")
    assert sum(int(np.prod(p.shape)) for p in net.parameters()) == 25557032


@pytest.mark.parametrize("build,count", [
    (lambda: tmodels.resnet18(device="cpu"), 11689512),
    (lambda: tmodels.resnet101(device="cpu"), 44549160),
    (lambda: tmodels.wide_resnet50_2(device="cpu"), 68883240),
    (lambda: tmodels.vgg11(batch_norm=True, device="cpu"), 132868840)],
    ids=["resnet18", "resnet101", "wide_resnet50_2", "vgg11_bn"])
def test_zoo_parameter_counts(build, count):
    """The other depths and widths, at the counts of their published
    ImageNet configurations (torchvision's)."""
    assert sum(p.numel() for p in build().parameters()) == count


def test_pretrained_raises():
    with pytest.raises(RuntimeError, match="network"):
        tmodels.resnet18(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        tmodels.resnet18(pretrained="weights.pdparams", device="cpu")
    with pytest.raises(RuntimeError, match="network"):
        tmodels.vgg11(pretrained=True, device="cpu")


# -- float32 forwards ---------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 50])
def test_float32_step1_statistics_and_eval_forward_match_jax(depth):
    """One ``train_batch(update=False)``: its loss (the train-mode
    forward) and the BN statistics it moved; then the eval-mode logits
    (``predict_batch``) on the JAX package's statistics, at 1e-5.
    ResNet-50's train-mode quantities hold to 1e-4 only: its 1x1 maps
    give variances of 4 values (2.1e-5 apart, loss 3.2e-4 measured)."""
    jnet = _jax_resnet(depth)
    arrays = _arrays(jnet)
    tnet = _port_resnet(depth, arrays)
    x, y = _batch()
    jm, tm = _jax_model(jnet, 0.01), _port_model(tnet, 0.01)
    jloss = jm.train_batch([x], [y], update=False)[0]
    tloss = tm.train_batch([x], [y], update=False)[0]
    tol = TOL if depth == 18 else 1e-3
    assert _rel(tloss, jloss) < tol, (tloss, jloss)
    stats = _arrays(jnet)
    for n, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[n], rtol=tol / 10,
                                   atol=tol / 10, err_msg=n)
    _carry(stats, tnet)
    jeval = np.asarray(jm.predict_batch([x])._data)
    teval = tm.predict_batch([x]).numpy()
    np.testing.assert_allclose(teval, jeval, rtol=TOL, atol=TOL)


# -- float64: the train step's semantics --------------------------------------

@pytest.fixture(scope="module", params=[18, 50], ids=["resnet18", "resnet50"])
def f64_reference(request):
    """The JAX package in float64: step-1 gradients and BN statistics
    (``train_batch(update=False)``), then the curve: ResNet-18 10 steps at
    lr 0.01 (and the state after them), ResNet-50 bench.py's lr 0.1 over
    3 steps."""
    depth = request.param
    lr, steps = (0.01, 10) if depth == 18 else (0.1, 3)
    jnet = _jax_resnet(depth)
    arrays = _arrays(jnet)
    x, y = _batch(np.float64)
    with _jax_float64():
        jnet.astype("float64")
        m = _jax_model(jnet, lr)
        m.train_batch([x], [y], update=False)
        grads = {n: np.array(p._grad) for n, p in jnet.named_parameters()}
        stats = _arrays(jnet)
        m._optimizer.clear_grad()
        losses = [m.train_batch([x], [y])[0] for _ in range(steps)]
        after = _arrays(jnet)
    return dict(depth=depth, lr=lr, arrays=arrays, grads=grads, stats=stats,
                losses=losses, after=after)


def test_float64_train_step_matches_jax(f64_reference):
    ref = f64_reference
    tnet = _port_resnet(ref["depth"], ref["arrays"]).double()
    m = _port_model(tnet, ref["lr"])
    x, y = _batch(np.float64)
    m.train_batch([x], [y], update=False)
    top = max(np.abs(g).max() for g in ref["grads"].values())
    for n, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref["grads"][n], rtol=0,
                                   atol=F64_TOL * top, err_msg=n)
    for n, b in tnet.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref["stats"][n], rtol=F64_TOL,
                                   atol=F64_TOL, err_msg=n)
    for p in tnet.parameters():
        p.grad = None
    losses = [m.train_batch([x], [y])[0] for _ in ref["losses"]]
    assert _rel(losses, ref["losses"]) < CURVE_TOL, (losses, ref["losses"])
    assert np.isfinite(losses).all()
    assert m._train_step_fn["fn"].trace_counter["traces"] == 1
    # the coupled decay reaches BN's scales and biases as well
    for k, v in tnet.state_dict().items():
        want = ref["after"][k]
        np.testing.assert_allclose(v.numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)


# -- float32 training paths ---------------------------------------------------

def test_train_loop_equals_train_batch():
    """``train_loop`` over the batch stacked 10 times (parameters,
    gradients and velocities in flat buffers, Momentum's elementwise
    update with the coupled decay) gives the losses, weights and BN
    statistics of 10 ``train_batch`` calls, bitwise."""
    arrays = _arrays(_jax_resnet(18))
    x, y = _batch()
    ref_net = _port_resnet(18, arrays)
    ref = _port_model(ref_net, 0.01)
    want = [ref.train_batch([x], [y])[0] for _ in range(10)]
    net = _port_resnet(18, arrays)
    m = _port_model(net, 0.01)
    got = m.train_loop([np.stack([x] * 10)], [np.stack([y] * 10)])
    assert m._fused_loop is not None
    assert got == want
    for (k, a), b in zip(net.state_dict().items(),
                         ref_net.state_dict().values()):
        assert torch.equal(a, b), k


def _stage_types(net, x, cast, flat, relu):
    """The type of each stage's output of a ResNet forward under O1."""
    types = []
    with cast():
        out = x
        for name in ("conv1", "bn1", "relu", "maxpool", "layer1", "layer2",
                     "layer3", "layer4", "avgpool"):
            out = getattr(net, name)(out)
            types.append((name, str(out.dtype).split(".")[-1]))
        out = flat(out)
        types.append(("flatten", str(out.dtype).split(".")[-1]))
        out = net.fc(out)
        types.append(("fc", str(out.dtype).split(".")[-1]))
        types.append(("relu(fc)", str(relu(out).dtype).split(".")[-1]))
    return types


def test_o1_types_and_first_loss_match_jax():
    """O1 bfloat16: conv2d and the linear head in bfloat16, BN passing
    bfloat16 through (float32 statistics inside), ReLU and the pools in
    their input's type (the JAX package's ``amp`` lists); the first loss
    (float32) within 2e-2; 3 steps finite with float32 weights."""
    jnet = _jax_resnet(18)
    arrays = _arrays(jnet)
    x, y = _batch()
    jtypes = _stage_types(jnet, paddle.to_tensor(x), jamp.auto_cast,
                          lambda a: jops.flatten(a, 1), JF.relu)
    ttypes = _stage_types(_port_resnet(18, arrays), torch.from_numpy(x),
                          amp.auto_cast, lambda a: flatten(a, 1),
                          tnn.functional.relu)
    assert ttypes == jtypes
    assert dict(ttypes)["conv1"] == "bfloat16"
    jm = _jax_model(_jax_resnet(18), 0.01)
    tm = _port_model(_port_resnet(18, arrays), 0.01)
    with jamp.auto_cast():
        jloss = jm.train_batch([x], [y])[0]
    with amp.auto_cast():
        losses = [tm.train_batch([x], [y])[0] for _ in range(3)]
    assert _rel(losses[0], jloss) < AMP_TOL, (losses[0], jloss)
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in tm.network.parameters())


# -- LeNet and VGG ------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    ("lenet", (3, 1, 28, 28)),
    # 64 px: a 2x2 feature map pooled into 7x7 overlapping bins; the
    # classifier (linears, ReLU, dropout) left off (num_classes=0), the
    # BN feature stack on
    ("vgg11", (2, 3, 64, 64)),
    ("vgg11_bn", (2, 3, 64, 64))])
def test_lenet_and_vgg_forward_and_gradients_match_jax(name, shape):
    paddle.seed(0)
    build = {
        "lenet": lambda pkg, **kw: pkg.LeNet(**kw),
        "vgg11": lambda pkg, **kw: pkg.vgg11(num_classes=0, **kw),
        "vgg11_bn": lambda pkg, **kw: pkg.vgg11(batch_norm=True,
                                                num_classes=0, **kw)}[name]
    jnet = build(jmodels)
    tnet = _carry(_arrays(jnet), build(tmodels, device="cpu", seed=None))
    jnet.eval()
    tnet.eval()
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    jout = jnet(paddle.to_tensor(x))
    out = tnet(torch.from_numpy(x))
    if name == "lenet":
        y = np.random.RandomState(2).randint(0, CLASSES, shape[0])
        jloss = jnn.CrossEntropyLoss()(jout, paddle.to_tensor(y))
        tloss = tnn.CrossEntropyLoss()(out, torch.from_numpy(y))
    else:
        g = np.random.RandomState(2).standard_normal(
            tuple(out.shape)).astype(np.float32)
        jloss = (jout * paddle.to_tensor(g)).sum()
        tloss = (out * torch.from_numpy(g)).sum()
    jloss.backward()
    tloss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout._data),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=TOL)
    jparams = dict(jnet.named_parameters())
    for n, p in tnet.named_parameters():
        ref = np.asarray(jparams[n]._grad)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(), err_msg=n)


# -- the measurements the docstring cites -------------------------------------

def _port_f64_step1(depth, arrays, lr=0.01):
    """The port's float64 step-1 gradients and BN statistics."""
    tnet = _port_resnet(depth, arrays).double()
    x, y = _batch(np.float64)
    _port_model(tnet, lr).train_batch([x], [y], update=False)
    return ({n: p.grad.numpy() for n, p in tnet.named_parameters()},
            {n: b.numpy() for n, b in tnet.named_buffers()})


def _measure():
    """Print how far each package's float32 train step lies from float64
    at bench.py's CPU shape, how fast the two packages' float32 curves
    part, and how closely the float64 runs agree, from the repository's
    root: ``PYTHONPATH=. JAX_PLATFORMS=cpu python
    tests/test_torch_resnet.py``."""
    x, y = _batch()
    for depth in (18, 50):
        jnet = _jax_resnet(depth)
        arrays = _arrays(jnet)
        g64, _ = _port_f64_step1(depth, arrays)
        top = max(np.abs(g).max() for g in g64.values())
        jloss = _jax_model(jnet, 0.01).train_batch([x], [y],
                                                   update=False)[0]
        tnet = _port_resnet(depth, arrays)
        tloss = _port_model(tnet, 0.01).train_batch([x], [y],
                                                    update=False)[0]
        stats = _arrays(jnet)
        worst = max(np.abs(b.numpy() - stats[n]).max()
                    for n, b in tnet.named_buffers())
        print(f"ResNet-{depth} float32 train-mode pass: loss "
              f"{_rel(tloss, jloss):.3e} relative, BN statistics "
              f"{worst:.3e} apart")
        for what, grads in (
                ("JAX float32", {n: np.asarray(p._grad)
                                 for n, p in jnet.named_parameters()}),
                ("port float32", {n: p.grad.numpy()
                                  for n, p in tnet.named_parameters()})):
            dist = max(np.abs(grads[n] - g64[n]).max() for n in g64) / top
            print(f"ResNet-{depth} step-1 gradients, {what} vs float64: "
                  f"{dist:.3e} of the largest")
    for lr in (0.01, 1e-3, 1e-4):
        arrays = _arrays(_jax_resnet(50))
        jm = _jax_model(_jax_resnet(50), lr)
        jl = [jm.train_batch([x], [y])[0] for _ in range(3)]
        tm = _port_model(_port_resnet(50, arrays), lr)
        tl = [tm.train_batch([x], [y])[0] for _ in range(3)]
        rel = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
        print(f"ResNet-50 float32 curves at lr {lr}: JAX {np.round(jl, 5)}, "
              f"relative difference by step {np.array(rel)}")
    arrays = _arrays(_jax_resnet(18))
    jm = _jax_model(_jax_resnet(18), 0.01)
    tm = _port_model(_port_resnet(18, arrays), 0.01)
    with jamp.auto_cast():
        jl = [jm.train_batch([x], [y])[0] for _ in range(3)]
    with amp.auto_cast():
        tl = [tm.train_batch([x], [y])[0] for _ in range(3)]
    print(f"ResNet-18 O1 curves at lr 0.01: JAX {np.round(jl, 5)}, "
          f"relative difference by step "
          f"{np.array([abs(a - b) / abs(b) for a, b in zip(tl, jl)])}")
    x64 = _batch(np.float64)[0]
    for depth, lr, steps in ((18, 0.01, 10), (50, 0.01, 6), (50, 0.1, 3)):
        jnet = _jax_resnet(depth)
        arrays = _arrays(jnet)
        with _jax_float64():
            jnet.astype("float64")
            m = _jax_model(jnet, lr)
            m.train_batch([x64], [y], update=False)
            jg = {n: np.array(p._grad) for n, p in jnet.named_parameters()}
            js = _arrays(jnet)
            m._optimizer.clear_grad()
            jl = [m.train_batch([x64], [y])[0] for _ in range(steps)]
        tg, ts = _port_f64_step1(depth, arrays, lr)
        top = max(np.abs(g).max() for g in jg.values())
        tm = _port_model(_port_resnet(depth, arrays).double(), lr)
        tl = [tm.train_batch([x64], [y])[0] for _ in range(steps)]
        rel = [abs(a - b) / abs(b) for a, b in zip(tl, jl)]
        print(f"ResNet-{depth} float64: gradients "
              f"{max(np.abs(tg[n] - jg[n]).max() for n in jg) / top:.3e} of "
              f"the largest, BN statistics "
              f"{max(np.abs(ts[n] - js[n]).max() for n in ts):.3e}; lr {lr} "
              f"curve {np.round(jl, 5)}, relative difference by step "
              f"{np.array(rel)}")


if __name__ == "__main__":
    _measure()
