"""A paddle program written from the op surface, run on the port's Tensors
as written, against the JAX package on the CPU:

- the op-built GPT (``tests/test_torch_op_table.py`` ``op_built_gpt``: 2
  layers, hidden 64, 4 heads, S 16), flash and dense, in both packages
  from the same seeded NumPy weights through
  ``ParamAttr(initializer=Assign(...))``: 3 AdamW steps' losses within
  1e-4 and the first step's gradients within 1e-4; and on the port, its
  losses against ``GPTForCausalLM``'s dygraph losses from the same
  weights (the same op sequence: bitwise);
- the names: every entry of the reference's Tensor method table, in-place
  variant and dunder, every public function of its
  ``ops/{math,manipulation,creation,linalg}.py`` and
  ``nn/functional/{activation,common,norm,loss}.py``, its ``ops``
  namespace's fluid-era aliases and its ``nn.initializer`` exist in the
  port;
- (the op names each op table case passes to the AMP handler are held
  equal case by case in the per-module parity files, beside its values);
- a sample of ops under O1 and O2 bfloat16: output types equal by name and
  values within 2e-2.
"""
import ast
import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as J  # noqa: E402
import paddle_tpu.amp as jamp  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.core.dtypes import dtype_name  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from test_torch_op_table import (OP_CASES, gpt_weight_names,  # noqa: E402
                             op_built_gpt)

CFG = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_dropout_prob=0.0)
BATCH, SEQ, STEPS = 2, 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _cpu_and_amp():
    saved = tdevice._CURRENT[0], dict(tamp._STATE), dict(jamp._STATE)
    P.set_device("cpu")
    yield
    tdevice._CURRENT[0] = saved[0]
    tamp._STATE.update(saved[1])
    jamp._STATE.update(saved[2])


def _weights(seed=0):
    """Seeded GPT weights by name: N(0, 0.05) matrices and embeddings,
    LayerNorm scales near 1, small biases."""
    rng = np.random.default_rng(seed)
    h, ff, v, n = (CFG["hidden_size"], 4 * CFG["hidden_size"],
                   CFG["vocab_size"], CFG["max_position_embeddings"])
    shapes = {"word_embeddings": (v, h), "position_embeddings": (n, h),
              "linear1.weight": (h, ff), "linear1.bias": (ff,),
              "linear2.weight": (ff, h)}
    out = {}
    for name in gpt_weight_names(CFG["num_layers"]):
        shape = next((s for k, s in shapes.items() if k in name), None)
        if shape is None:
            shape = (h, h) if name.endswith("proj.weight") else (h,)
        base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
        scale = 0.02 if name.endswith("bias") else 0.05
        out[name] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)
    return out


def _ids(seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int64)


def _train(m, net, ids, steps=STEPS):
    """``steps`` dygraph AdamW steps: the losses and the first step's
    gradients (in parameter order)."""
    opt = m.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                            parameters=net.parameters())
    x = m.to_tensor(ids)
    losses, grads = [], None
    for _ in range(steps):
        loss = net.loss(net(x), x)
        loss.backward()
        if grads is None:
            grads = [np.asarray(p.grad.numpy()) if hasattr(p.grad, "numpy")
                     else p.grad.detach().numpy() for p in net.parameters()]
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, grads


@pytest.mark.parametrize("dense", [False, True], ids=["flash", "dense"])
def test_op_built_gpt_trains_as_the_jax_package(dense):
    w, ids = _weights(), _ids()
    kw = dict(num_layers=CFG["num_layers"], num_heads=CFG["num_heads"],
              dense=dense)
    t_losses, t_grads = _train(P, op_built_gpt(P, w, **kw), ids)
    j_losses, j_grads = _train(J, op_built_gpt(J, w, **kw), ids)
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    assert len(t_grads) == len(j_grads) == len(w)
    for name, a, b in zip(gpt_weight_names(CFG["num_layers"]), t_grads,
                          j_grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(
            1.0, float(np.abs(b).max())), err_msg=name)
    assert t_losses[-1] < t_losses[0]


@pytest.mark.parametrize("impl,heads", [("flash", 2), ("dense", 4)])
def test_op_built_gpt_equals_gpt_for_causal_lm_bitwise(impl, heads):
    """The same op sequence as the port's layers (linear = matmul + bias,
    the position ids tiled over the batch), so the dygraph losses of the
    two from the same weights are bitwise equal: through the flash op at
    head dim 32 (one the kernels take, so the layers take it too) and
    through the dense branch at head dim 16."""
    cfg = dict(CFG, num_heads=heads)
    ref = GPTForCausalLM(GPTConfig(**cfg, attn_impl=impl), device="cpu",
                         seed=3)
    w = {k: v.detach().numpy().copy() for k, v in ref.state_dict().items()}
    ids = _ids(4)
    net = op_built_gpt(P, w, CFG["num_layers"], heads,
                       dense=impl == "dense")
    got, _ = _train(P, net, ids)
    want, _ = _train(P, _Wrapped(ref), ids)
    assert got == want, (got, want)


class _Wrapped(P.nn.Layer):
    """``GPTForCausalLM`` with the program's criterion."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x)

    @staticmethod
    def loss(logits, x):
        from paddle_tpu_torch.models import GPTPretrainingCriterion
        return GPTPretrainingCriterion()(logits, x)


def test_op_built_gpt_trains_through_model_train_batch():
    """The program as a ``Model`` network: ``train_batch`` (one compiled
    step per signature; eager on the CPU) gives the dygraph loop's
    losses."""
    w, ids = _weights(5), _ids(6)
    net = op_built_gpt(P, w, CFG["num_layers"], CFG["num_heads"])
    model = P.Model(net, device="cpu")
    model.prepare(P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=net.parameters()), net.loss)
    got = [float(model.train_batch([ids], [ids])[0]) for _ in range(STEPS)]
    want, _ = _train(P, op_built_gpt(P, w, CFG["num_layers"],
                                     CFG["num_heads"]), ids)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# -- the names ------------------------------------------------------------------

def _reference_method_names():
    """Every name the reference's ``_attach_methods`` puts on the Tensor:
    the method table's keys, the in-place variants, the dunders and the
    attributes it assigns (``ops/__init__.py:48-185``)."""
    tree = ast.parse(inspect.getsource(J.ops._attach_methods))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            names |= {k.value for k in node.keys
                      if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name) and t.value.id == "Tensor":
                    names.add(t.attr)
    return sorted(names)


def test_tensor_carries_the_reference_method_table():
    names = _reference_method_names()
    assert len(names) > 180
    missing = [n for n in names if not hasattr(P.Tensor, n)]
    assert missing == []
    t = P.to_tensor(np.arange(6.0, dtype=np.float32).reshape(2, 3))
    assert t.T.shape == [3, 2] and t.t().shape == [3, 2]
    assert int(t.numel()) == 6 and not bool(t.is_empty())


def _defined_functions(module):
    return sorted(n for n, v in vars(module).items()
                  if callable(v) and not n.startswith("_")
                  and getattr(v, "__module__", None) == module.__name__)


@pytest.mark.parametrize("ref,port", [
    ("ops.math", "ops.math"), ("ops.manipulation", "ops.manipulation"),
    ("ops.creation", "ops.creation"), ("ops.linalg", "ops.linalg"),
    ("nn.functional.activation", "nn.functional.activation"),
    ("nn.functional.common", "nn.functional.common"),
    ("nn.functional.norm", "nn.functional.norm"),
    ("nn.functional.loss", "nn.functional.loss"),
    ("nn.initializer", "nn.initializer"),
])
def test_every_reference_function_of_the_module_is_ported(ref, port):
    import importlib
    jmod = importlib.import_module("paddle_tpu." + ref)
    tmod = importlib.import_module("paddle_tpu_torch." + port)
    names = _defined_functions(jmod)
    if ref == "nn.initializer":
        names += [n for n, v in vars(jmod).items()
                  if inspect.isclass(v) and not n.startswith("_")]
    assert names
    missing = [n for n in names if not hasattr(tmod, n)]
    assert missing == []
    if ref.startswith("nn.functional"):
        assert [n for n in names if not hasattr(P.nn.functional, n)] == []
    elif ref.startswith("ops."):
        host = P.linalg if ref == "ops.linalg" else P.ops
        assert [n for n in names if not hasattr(host, n)] == []


def test_namespaces_carry_the_late_aliases_and_extras():
    late = ["logsigmoid", "hard_sigmoid", "hard_shrink", "tanh_shrink",
            "hard_swish", "brelu", "kldiv_loss", "arg_max", "arg_min", "mul",
            "minus", "reverse", "fill_constant", "reduce_sum",
            "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
            "reduce_all", "reduce_any", "elementwise_add",
            "elementwise_sub", "elementwise_mul", "elementwise_div",
            "elementwise_pow", "elementwise_max", "elementwise_min",
            "elementwise_mod", "elementwise_floordiv", "expand_as_v2",
            "expand_v2", "matmul_v2", "one_hot_v2", "p_norm", "stanh",
            "soft_relu", "flash_attention", "cholesky", "inverse", "det",
            "slogdet", "qr", "svd", "lstsq", "relu", "gelu", "softmax",
            "dropout", "kl_div", "one_hot", "pixel_shuffle"]
    for n in late:
        assert hasattr(J.ops, n), n
        assert hasattr(P.ops, n), n
    for n in ("linalg", "cholesky", "inverse", "matrix_power", "ParamAttr",
              "reverse", "flash_attention"):
        assert hasattr(P, n) and hasattr(J, n), n
    for n in ("flash_attention", "pixel_shuffle", "pixel_unshuffle",
              "tanh_", "elu_", "softmax_"):
        assert hasattr(P.nn.functional, n) and hasattr(J.nn.functional, n)
    # ops.flash_attention is the op, as in the reference's namespace
    assert P.ops.flash_attention is P.nn.functional.flash_attention
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 8, 2, 16)).astype(np.float32))
    out, _ = P.ops.flash_attention(q, q, q, causal=True)
    ref, _ = P.nn.functional.flash_attention(q, q, q, causal=True)
    assert torch.equal(out, ref)


# -- a sample under O1 and O2 bfloat16 ------------------------------------------------

AMP_SAMPLE = ["matmul", "matmul_transposes", "bmm", "addmm", "einsum",
              "F.linear", "F.softmax", "F.log_softmax", "F.layer_norm",
              "F.gelu", "exp", "sum_axis1", "mean_all", "logsumexp_all",
              "F.mse_loss_mean", "F.bce_with_logits", "reshape",
              "transpose", "concat", "tanh", "sigmoid", "F.group_norm",
              "F.instance_norm", "cumsum", "norm_fro", "F.kl_div", "where",
              "masked_fill", "gather", "F.embedding", "F.cross_entropy_soft",
              "F.npair_loss", "scale", "clip", "maximum", "F.silu",
              "F.hardswish", "std", "argmax", "topk"]


def _amp_outputs(m, case, level):
    arrays = case.arrays()
    with m.amp.auto_cast(level=level, dtype="bfloat16"):
        out = case.op(m, *[m.to_tensor(a) for a in arrays])
    leaves = out if isinstance(out, (list, tuple)) else [out]
    res = []
    for v in leaves:
        name = dtype_name(v.dtype) if m is P else np.dtype(v.dtype).name
        res.append((name, np.asarray(v.numpy()).astype(np.float64)))
    return res


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_sample_matches_the_jax_package(level):
    by_name = {c.name: c for c in OP_CASES}
    narrow = {"int64": "int32", "float64": "float32"}
    for name in AMP_SAMPLE:
        case = by_name[name]
        got, want = _amp_outputs(P, case, level), _amp_outputs(J, case,
                                                               level)
        assert len(got) == len(want), name
        for (gd, g), (wd, w) in zip(got, want):
            assert narrow.get(gd, gd) == wd, (name, level, gd, wd)
            np.testing.assert_allclose(
                g, w, rtol=2e-2, atol=2e-2 * max(1.0, float(np.abs(w).max())),
                err_msg=f"{name} {level}")


def test_in_place_methods_and_operators_match_the_jax_package():
    x = np.random.default_rng(7).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    outs = []
    for m in (P, J):
        t = m.to_tensor(x, stop_gradient=False)
        y = t * 1.0
        y.add_(m.ones([3, 4])).scale_(0.5).exp_().clip_(0.0, 3.0)
        y.sqrt_().rsqrt_().reciprocal_().tanh_()
        z = (y.reshape([4, 3]).T @ y.T).flatten()
        z = z.scatter_(m.to_tensor(np.array([0, 5])), m.ones([2])).floor_()
        w = (-y) ** 2 // 0.5 % 3.0 + abs(y) - 1 / (y + 1)
        (w.sum() + z.sum()).backward()
        outs.append((y.numpy(), z.numpy(), w.numpy(), t.grad.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
