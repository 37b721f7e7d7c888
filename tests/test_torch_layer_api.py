"""The port's ``Layer`` API (``nn/layer_base.py``) against the JAX
package's on the CPU: the forward hooks (order, removal, replacement
rules, the caller's types), the walkers (``parameters``,
``named_sublayers``, ``buffers``; dedup), ``state_dict``/
``set_state_dict`` (shape check, missing and unexpected keys, copied in
place), ``to``/``astype``, ``apply``, ``full_name`` and ``__repr__``;
torch's own keywords where torch's code passes them; the construction
repair (every parameter drawn at construction, ``paddle.seed`` fixes
it, the reference's default initializers' moments) and
``reset_parameters`` reaching a layer of every class that owns
parameters. Then the activation and loss layers of the layer table
(``LAYER_CASES``, module ``activation``) against the JAX package."""
import copy

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.nn.layers_common import reset_parameters  # noqa: E402
from test_torch_nn_layers_a3 import check_layer_against_jax  # noqa: E402
from test_torch_op_table import LAYER_CASES  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu():
    saved = tdevice._CURRENT[0]
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved


@pytest.mark.parametrize("case", [c for c in LAYER_CASES
                                  if c.module == "activation"], ids=repr)
def test_activation_and_loss_layers_match_jax(case):
    check_layer_against_jax(case)


@pytest.mark.parametrize("m", [J, P], ids=["jax", "port"])
def test_hooks_run_in_order_and_are_removed(m):
    """``tests/test_nn_layers.py:226-236`` in both packages, and the
    replacement rules: a pre-hook's return replaces the inputs, a
    post-hook's the outputs, None keeps them."""
    lin = m.nn.Linear(2, 2)
    calls = []
    h1 = lin.register_forward_pre_hook(lambda l, i: calls.append("pre"))
    h2 = lin.register_forward_post_hook(
        lambda l, i, o: calls.append("post"))
    x = m.to_tensor(np.ones((1, 2), np.float32))
    lin(x)
    assert calls == ["pre", "post"]
    h1.remove(), h2.remove()
    lin(x)
    assert calls == ["pre", "post"]
    h = lin.register_forward_pre_hook(lambda l, i: (i[0] * 0.0,))
    np.testing.assert_array_equal(lin(x).numpy(), np.broadcast_to(
        lin.bias.numpy(), (1, 2)))
    h.remove()
    h = lin.register_forward_post_hook(lambda l, i, o: o + 1.0)
    base = x.numpy() @ lin.weight.numpy() + lin.bias.numpy()
    np.testing.assert_allclose(lin(x).numpy(), base + 1.0, rtol=1e-6)
    h.remove()


def test_hooks_see_the_callers_types():
    """Tensors in: the hooks see Tensors; torch tensors in (``Model``,
    the engines): torch tensors."""
    lin = P.nn.Linear(2, 2)
    seen = []
    lin.register_forward_pre_hook(lambda l, i: seen.append(type(i[0])))
    lin.register_forward_post_hook(lambda l, i, o: seen.append(type(o)))
    lin(P.to_tensor(np.ones((1, 2), np.float32)))
    lin(torch.ones(1, 2))
    assert seen == [P.Tensor, P.Tensor, torch.Tensor, torch.Tensor]


@pytest.mark.parametrize("m", [J, P], ids=["jax", "port"])
def test_state_dict_round_trip_train_eval_and_dedup(m):
    """``tests/test_nn_layers.py:238-262`` in both packages."""
    nn = m.nn
    a = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    b = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    assert b.set_state_dict(a.state_dict()) == ([], [])
    x = m.to_tensor(np.random.default_rng(0).standard_normal(
        (2, 3)).astype(np.float32))
    np.testing.assert_array_equal(a(x).numpy(), b(x).numpy())
    seq = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
    seq.eval()
    assert not seq[1].training
    ones = m.to_tensor(np.ones((4, 2), np.float32))
    np.testing.assert_array_equal(seq[1](ones).numpy(), ones.numpy())
    shared = nn.Linear(2, 2)

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = shared
            self.b = shared

        def forward(self, x):
            return self.b(self.a(x))
    assert len(M().parameters()) == 2
    assert len(M().sublayers()) == 1


def _names(m):
    nn = m.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(nn.Linear(2, 3), nn.BatchNorm1D(3))
            self.head = nn.Linear(3, 1)
            self.scale = self.create_parameter([1])

        def forward(self, x):
            return self.head(self.body(x)) * self.scale
    net = Net()
    return {
        "params": [n for n, _ in net.named_parameters()],
        "own": [n for n, _ in net.named_parameters(
            include_sublayers=False)],
        "sublayers": [n for n, _ in net.named_sublayers()],
        "with_self": [n for n, _ in net.named_sublayers(include_self=True)],
        "buffers": [n for n, _ in net.named_buffers()],
        "state": sorted(net.state_dict()),
        "prefixed": sorted(net.state_dict(structured_name_prefix="m.")),
        "n_sub": len(net.sublayers(include_self=True)),
    }


def test_walkers_name_what_the_reference_names():
    got, ref = _names(P), _names(J)
    for k in ref:
        if k == "n_sub":
            assert got[k] == ref[k]
            continue
        assert sorted(got[k]) == sorted(ref[k]), k
    assert got["params"] == ["scale", "body.0.weight", "body.0.bias",
                             "body.1.weight", "body.1.bias", "head.weight",
                             "head.bias"]


def test_set_state_dict_checks_shapes_and_copies_in_place():
    lin = P.nn.Linear(3, 2)
    ptr = lin.weight.data_ptr()
    w = np.arange(6, dtype=np.float64).reshape(3, 2)
    missing, unexpected = lin.set_state_dict({"weight": w, "extra": w})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert lin.weight.data_ptr() == ptr and lin.weight.dtype == torch.float32
    np.testing.assert_array_equal(lin.weight.detach().numpy(), w)
    with pytest.raises(ValueError, match="shape mismatch"):
        lin.load_dict({"weight": np.zeros((2, 3), np.float32)})
    jl = J.nn.Linear(3, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        jl.set_state_dict({"weight": np.zeros((2, 3), np.float32)})
    # a paddle.save file of the port loads back in place
    lin.set_state_dict(P.to_tensor(np.ones((1,), np.float32)) and
                       {k: P.to_tensor(v.numpy())
                        for k, v in P.nn.Linear(3, 2).state_dict().items()})
    assert lin.weight.data_ptr() == ptr


def test_buffers_persistable_and_own_state():
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.register_buffer("kept", torch.ones(2))
            self.register_buffer("scratch", torch.zeros(2),
                                 persistable=False)
            self.sub = P.nn.BatchNorm1D(2)
    net = Net()
    assert sorted(net.state_dict()) == ["kept", "sub._mean", "sub._variance",
                                        "sub.bias", "sub.weight"]
    assert sorted(net.state_dict(include_sublayers=False)) == ["kept"]
    assert [n for n, _ in net.named_buffers(include_sublayers=False)] == [
        "kept", "scratch"]
    assert len(net.buffers()) == 4
    t = net.create_tensor(dtype="float64")
    assert isinstance(t, P.Tensor) and t.dtype == P.float64
    lin = P.nn.Linear(2, 2)
    net.add_sublayer("extra", lin)
    assert net.extra is lin
    net.add_parameter("w", torch.ones(3))
    assert isinstance(net.w, P.Parameter) and "w" in net.state_dict()


def test_torch_keywords_still_work():
    """torch's own callers of the same names: ``state_dict(prefix=,
    keep_vars=)``, ``named_parameters(remove_duplicate=)``,
    ``register_buffer(persistent=)``, ``load_state_dict``,
    ``copy.deepcopy``, ``Module.to(torch.float64)``."""
    net = P.nn.Sequential(P.nn.Linear(2, 3), P.nn.Linear(3, 1))
    sd = net.state_dict(prefix="x.", keep_vars=True)
    assert list(sd) == ["x.0.weight", "x.0.bias", "x.1.weight", "x.1.bias"]
    assert sd["x.0.weight"] is net[0].weight
    net.register_buffer("b", torch.zeros(1), persistent=False)
    assert "b" not in net.state_dict()
    assert len(list(net.named_parameters(remove_duplicate=False))) == 4
    twin = copy.deepcopy(net)
    twin.load_state_dict(net.state_dict())
    assert torch.equal(twin[0].weight, net[0].weight)
    assert net.to(torch.float64)[0].weight.dtype == torch.float64


def test_to_astype_apply_full_name_and_repr():
    net = P.nn.Sequential(P.nn.Linear(2, 3), P.nn.ReLU())
    assert net.astype("float16")[0].weight.dtype == torch.float16
    assert net.to(dtype="bfloat16")[0].weight.dtype == torch.bfloat16
    assert net.to("cpu", "float32")[0].bias.dtype == torch.float32
    order = []
    net.apply(lambda l: order.append(type(l).__name__))
    assert order == ["Sequential", "Linear", "ReLU"]
    name = P.nn.Linear(1, 1).full_name()
    assert name.startswith("linear_")
    assert P.nn.Layer(name_scope="blk").full_name() == "blk"
    jnet = J.nn.Sequential(J.nn.Linear(2, 3), J.nn.ReLU())
    assert repr(net) == repr(jnet)
    x = P.to_tensor(np.ones((1, 2), np.float32), stop_gradient=False)
    net(x).sum().backward()
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())


# -- the construction repair --------------------------------------------------

def _every_param_layer(nn, dev=None):
    kw = {} if dev is None else {"device": dev}
    return [
        nn.Linear(6, 5, **kw), nn.Conv1D(3, 4, 3, **kw),
        nn.Conv2D(3, 4, 3, **kw), nn.Conv3D(2, 3, 2, **kw),
        nn.Conv1DTranspose(3, 4, 3, **kw), nn.Conv2DTranspose(4, 6, 3,
                                                              groups=2, **kw),
        nn.Conv3DTranspose(2, 3, 2, **kw), nn.Embedding(7, 4, padding_idx=2,
                                                        **kw),
        nn.LayerNorm(4, **kw), nn.BatchNorm(3, **kw), nn.BatchNorm1D(3, **kw),
        nn.BatchNorm2D(3, **kw), nn.BatchNorm3D(3, **kw),
        nn.SyncBatchNorm(3, **kw), nn.GroupNorm(2, 4, **kw),
        nn.InstanceNorm1D(3, **kw), nn.InstanceNorm2D(3, **kw),
        nn.InstanceNorm3D(3, **kw), nn.SpectralNorm([4, 5], **kw),
        nn.Bilinear(3, 4, 5, **kw), nn.PReLU(3, **kw),
        nn.HSigmoidLoss(4, 6, **kw), nn.MultiHeadAttention(8, 2, **kw)]


def test_construction_draws_every_parameter_and_seed_fixes_it():
    P.seed(11)
    a = _every_param_layer(P.nn)
    P.seed(11)
    b = _every_param_layer(P.nn)
    for la, lb in zip(a, b):
        for (n, p), (_, q) in zip(la.named_parameters(),
                                  lb.named_parameters()):
            assert torch.equal(p, q), (type(la).__name__, n)
            assert bool(torch.isfinite(p).all()), (type(la).__name__, n)
    P.seed(12)
    c = _every_param_layer(P.nn)
    assert not torch.equal(a[0].weight, c[0].weight)
    assert torch.equal(a[7].weight[2], torch.zeros(4))   # padding row


@pytest.mark.parametrize("build,name,var", [
    (lambda m: m.nn.Linear(300, 200), "weight", 6.0 / 500 / 3),
    (lambda m: m.nn.Linear(300, 200), "bias", 0.0),
    (lambda m: m.nn.Conv2D(16, 32, 3), "weight", 1.0 / 144 / 3),
    (lambda m: m.nn.Conv2D(16, 32, 3), "bias", 1.0 / 144 / 3),
    (lambda m: m.nn.Embedding(400, 200), "weight", 1.0),
    (lambda m: m.nn.Conv2DTranspose(16, 32, 3), "weight", 1.0 / 144 / 3),
], ids=["linear_w", "linear_b", "conv_w", "conv_b", "embedding",
        "conv_transpose_w"])
def test_default_initializers_match_the_reference_moments(build, name, var):
    """A bare layer's parameters follow the reference's default
    initializers (Xavier-uniform and zeros for ``Linear``,
    ``Uniform(+-sqrt(1/fan_in))`` for a convolution, ``Normal(0, 1)``
    for ``Embedding``): mean and variance against the formula and against
    the JAX package's draw."""
    P.seed(0)
    got = getattr(build(P), name).detach().numpy()
    ref = getattr(build(J), name).numpy()
    tol = 0.05 * var + 1e-12
    for a in (got, ref):
        assert abs(a.mean()) < 3 * np.sqrt(var / a.size) + 1e-12
        assert abs(a.var() - var) < max(tol, 6 * var / np.sqrt(a.size))
    if var:
        lim = np.abs(ref).max()
        assert np.abs(got).max() <= lim * 1.01 or name == "weight" and \
            isinstance(build(P), P.nn.Embedding)


def test_reset_parameters_reaches_every_layer_that_owns_parameters():
    """``reset_parameters(model, gen)`` re-draws each sublayer with a
    ``reset_parameters``, in registration order: two models built from
    different seeds agree after a reset from the same generator seed, and
    a reset moves every random parameter."""
    P.seed(1)
    a = P.nn.LayerList(_every_param_layer(P.nn))
    P.seed(2)
    b = P.nn.LayerList(_every_param_layer(P.nn))
    before = {n: p.detach().clone() for n, p in a.named_parameters()}
    for net in (a, b):
        gen = torch.Generator()
        gen.manual_seed(5)
        reset_parameters(net, gen)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    constant = ("bias", "_mean", "weight_g")
    moved = [n for n, p in a.named_parameters()
             if not torch.equal(p, before[n])]
    for n in before:
        layer = a[int(n.split(".")[0])]
        random_init = not isinstance(layer, (
            P.nn.LayerNorm, P.nn.layers_common._BatchNormBase,
            P.nn.GroupNorm, P.nn.InstanceNorm1D, P.nn.PReLU)) and not (
            n.endswith("bias") and not isinstance(layer, (
                P.nn.layers_common._ConvNd,)))
        assert (n in moved) == random_init or n.endswith(constant), n


@torch.no_grad()
def _in_place_draws(net, seed):
    """The seeded models' draws as in-place ops of one generator, layer by
    layer in registration order: ``uniform_`` within Xavier's limit and
    zeros for ``Linear``, ``uniform_`` within ``sqrt(1/fan_in)`` for a
    convolution's weight and bias, ``normal_(0, init_std)`` for
    ``Embedding`` (its padding row zero), ones and zeros for the norms."""
    nn = P.nn
    gen = torch.Generator()
    gen.manual_seed(seed)
    for m in net.modules():
        if isinstance(m, nn.Linear):
            fi, fo = m.weight.shape
            lim = (6.0 / (fi + fo)) ** 0.5
            m.weight.uniform_(-lim, lim, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.layers_common._ConvNd):
            lim = (1.0 / m._fan_in) ** 0.5
            m.weight.uniform_(-lim, lim, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-lim, lim, generator=gen)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m._init_std, generator=gen)
            if m._padding_idx is not None:
                m.weight[m._padding_idx].zero_()
        elif isinstance(m, (nn.LayerNorm, nn.layers_common._BatchNormBase)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            assert not list(m.parameters(include_sublayers=False)), m


def _seeded_models():
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification,
                                         GPTConfig, GPTForCausalLM)
    vm = P.vision.models
    return {
        "gpt": lambda s: GPTForCausalLM(GPTConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=16), device="cpu", seed=s),
        "bert": lambda s: BertForSequenceClassification(BertConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=16),
            device="cpu", seed=s),
        "resnet18": lambda s: vm.resnet18(num_classes=10, device="cpu",
                                          seed=s),
        "lenet": lambda s: vm.LeNet(device="cpu", seed=s),
        "vgg11": lambda s: vm.vgg11(num_classes=0, device="cpu", seed=s),
        "yolov3": lambda s: vm.YOLOv3(num_classes=4, width_mult=0.125,
                                      device="cpu", seed=s),
        "mobilenet_v3_small": lambda s: vm.mobilenet_v3_small(
            scale=0.35, num_classes=10, device="cpu", seed=s),
    }


@pytest.mark.parametrize("name", list(_seeded_models()))
def test_seeded_models_draw_as_in_place_draws_of_one_generator(name):
    """A model built with ``seed`` holds, bit for bit, the parameters that
    in-place draws of a generator seeded alike give, so the
    initializers' callables keep the streams the models' seeds have
    always made."""
    net = _seeded_models()[name](3)
    ref = copy.deepcopy(net)
    _in_place_draws(ref, 3)
    got, want = net.state_dict(), ref.state_dict()
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
