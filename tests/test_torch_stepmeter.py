"""The port's ``observability.stepmeter`` against the JAX package's:
``StepMeter.step`` publishes equal stats for the same wall and FLOPs;
``compiled_flops`` of a matmul equals the reference's M*N*K; a GPT train
step with dense attention (``hidden_size=256``) counts its matrix
products exactly and reads 3-5% under the reference's XLA cost analysis,
which also counts element-wise work (``FlopCounterMode`` counts products
and convolutions only); ResNet-50
at batch 2 and 96x96 within 10% of ``bench.py``'s analytic count; and
the flash kernels' formulas against dense counts of the same shapes.
The port RUNS the counted function (the reference compiles it), so the
counts here are of eager CPU runs."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.models import GPTPretrainingCriterion as JCrit  # noqa: E402
from paddle_tpu.observability import stepmeter as jsm  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.observability import stepmeter as sm  # noqa: E402
import importlib  # noqa: E402

fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")


def test_step_publishes_the_same_stats():
    regs = []
    for mod, reg in ((sm, StatRegistry()), (jsm, JRegistry())):
        m = mod.StepMeter(peak_flops=1e9, registry=reg, prefix="train")
        m.set_flops_per_step(5e8)
        assert m.step(0.5) == pytest.approx(1.0)
        assert m.step(1.0, flops=2e9) == pytest.approx(2.0)
        assert m.step(0.0) is None
        assert mod.StepMeter(peak_flops=1e9, registry=reg,
                             prefix="x").step(0.5) is None
        regs.append(reg.snapshot())
    assert regs[0] == regs[1]


def test_peak_flops_env_override_cpu_proxy_and_unknown_card(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "123e9")
    assert sm.default_peak_flops("cpu") == 123e9 == jsm.default_peak_flops()
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
    assert sm.default_peak_flops("cpu") == 1.0e12
    from paddle_tpu_torch.core import device as _device
    monkeypatch.setattr(_device, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card X")
    with pytest.raises(ValueError, match="PADDLE_TPU_PEAK_FLOPS"):
        sm.default_peak_flops(torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: "NVIDIA H100 80GB HBM3")
    assert sm.default_peak_flops(torch.device("cuda", 0)) == 989.0e12


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (32, 48, 80)])
def test_matmul_counts_mnk_as_the_reference(m, k, n):
    import jax.numpy as jnp
    ja, jb = jnp.ones((m, k), jnp.float32), jnp.ones((k, n), jnp.float32)
    ref = jsm.compiled_flops(lambda x, y: x @ y, ja, jb)
    a, b = torch.ones(m, k), torch.ones(k, n)
    assert sm.compiled_flops(lambda x, y: x @ y, a, b) == m * n * k == ref
    assert sm.compiled_flops(lambda x, y: x @ y, a, b,
                             mac_convention=False) == 2 * m * n * k
    assert sm.compiled_flops(lambda x: x + 1, a) is None
    meter = sm.StepMeter(peak_flops=1e9, registry=StatRegistry())
    assert meter.measure_flops(torch.matmul, a, b) == m * n * k
    with pytest.raises(RuntimeError, match="already"):
        sm.compiled_flops(lambda: sm.compiled_flops(torch.matmul, a, b))
    assert not sm.counting()


def _gpt_cfg(cls, **kw):
    return cls(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0, **kw)


def test_dense_gpt_step_counts_the_products_and_trails_xla_by_its_rest():
    """XLA's cost analysis also counts element-wise work (GELU, softmax,
    LayerNorm, the loss, AdamW's update): at this shape the reference
    reads 4.4% more than the port (2.6-3.3% at widths 512 and 1024), so
    the 2% a GELU MLP meets at this width does not hold for a GPT; the
    port is held to the products' analytic count exactly instead."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 64)).astype(np.int64)
    paddle.seed(0)
    jnet = JGPT(_gpt_cfg(JGPTConfig, attn_impl="dense"))
    jm = paddle.Model(jnet)
    jm.prepare(jopt.AdamW(learning_rate=1e-3,
                          parameters=jnet.parameters()), JCrit())
    jreg = JRegistry()
    jm.attach_step_meter(jsm.StepMeter(peak_flops=1e12, registry=jreg))
    jm.train_batch([paddle.to_tensor(ids)], [paddle.to_tensor(ids)])
    ref = jreg.get("train.flops_per_step")

    net = GPTForCausalLM(_gpt_cfg(GPTConfig, attn_impl="dense"),
                         device="cpu", seed=0)
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=net.parameters(), device="cpu"),
              GPTPretrainingCriterion())
    reg = StatRegistry()
    m.attach_step_meter(sm.StepMeter(peak_flops=1e12, registry=reg))
    m.train_batch([ids], [ids])
    mine = reg.get("train.flops_per_step")
    # the matrix products alone, MAC convention: 3 x forward (the
    # forward, the input and the weight gradients) with the embedding
    # lookup free and the LM head tied; dense attention 2*T*S*h a layer
    t, s, h, v, layers = 2 * 64, 64, 256, 512, 2
    analytic = 3 * (t * (12 * layers * h * h + h * v)
                    + layers * 2 * t * s * h)
    assert mine == analytic
    assert 1.0 < ref / mine < 1.05


def test_resnet50_at_96_within_10pct_of_the_analytic_count():
    from paddle_tpu_torch.vision.models import resnet50
    batch, size = 2, 96            # 96 = 224*3/7: the conv grid scales
    net = resnet50(num_classes=1000, device="cpu", seed=0)
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                   parameters=net.parameters(),
                                   device="cpu"),
              P.nn.CrossEntropyLoss())
    reg = StatRegistry()
    m.attach_step_meter(sm.StepMeter(registry=reg, device="cpu"))
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, size, size).astype(np.float32)
    y = rng.randint(0, 1000, (batch,)).astype(np.int64)
    m.train_batch([x], [y])
    measured = reg.get("train.flops_per_step")
    # bench.py: fwd+bwd ~= 3x fwd; ResNet-50 fwd @224 = 4.09 GFLOPs an
    # image (MAC convention), quadratic in the image size
    analytic = batch * 3 * 4.09e9 * (size / 224.0) ** 2
    assert measured == pytest.approx(analytic, rel=0.10)
    assert reg.get("train.mfu") > 0


def _count(fn, *args):
    with FlopCounterMode(display=False) as c:
        fn(*args)
    return c.get_total_flops()


@pytest.mark.parametrize("sq,skv,causal", [(32, 32, False), (32, 32, True),
                                           (16, 48, True), (48, 16, True)])
def test_flash_formulas_equal_dense_counts(sq, skv, causal):
    b, h, d = 2, 4, 32
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, skv, h, d, generator=g)
    v = torch.randn(b, skv, h, d, generator=g)
    pairs = fa.attention_pairs(sq, skv, causal)
    mask = fa._causal_mask(sq, skv, "cpu") if causal else \
        torch.ones(sq, skv, dtype=torch.bool)
    assert pairs == int(mask.sum())
    # a dense product over every pair, scaled to the pairs attended
    qb, kb, vb = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    one = _count(lambda: qb @ kb.transpose(-1, -2)) * pairs / (sq * skv)
    assert one == 2 * b * h * d * pairs
    # B1: S and O; B2: S, dP and dQ; B3: S, dP, dK and dV
    for kernel, products in (("flash_attention_fwd", 2),
                             ("flash_attention_bwd_dq", 3),
                             ("flash_attention_bwd_dkv", 4)):
        assert fa._PAIR_FLOPS[kernel] * b * h * d * pairs == products * one
    # the counted forward and backward equal the formulas on the CPU,
    # where the plain versions run hidden from the counter
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)

    def step():
        out = fa.FlashAttentionFunction.apply(q, k, v, causal, None)
        out.sum().backward()

    _, raw, by = sm.count_flops(step)
    assert by == {"flash_attention_fwd": 2 * one,
                  "flash_attention_bwd_dq": 3 * one,
                  "flash_attention_bwd_dkv": 4 * one}
    assert raw == 9 * one
    # outside a count the plain versions run as before, noting nothing
    assert _count(lambda: fa.flash_attention_fwd(q.detach(), k.detach(),
                                                 v.detach(), causal)) > 0


def test_paged_formula_counts_the_attended_rows():
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    s, h, d, page, pps = 3, 2, 16, 4, 3
    g = torch.Generator().manual_seed(1)
    q = torch.randn(s, h, d, generator=g)
    arena_k = torch.randn(1 + s * pps, page, h, d, generator=g)
    arena_v = torch.randn(1 + s * pps, page, h, d, generator=g)
    tables = torch.arange(1, 1 + s * pps, dtype=torch.int32).view(s, pps)
    positions = torch.tensor([0, 5, 30], dtype=torch.int32)
    out, raw, by = sm.count_flops(pa.paged_attention, q, arena_k, arena_v,
                                  tables, positions)
    rows = 1 + 6 + pps * page          # the last clipped to its pages
    assert by == {"paged_attention": 4.0 * rows * h * d} and raw == 4.0 * \
        rows * h * d
    torch.testing.assert_close(out, pa.paged_attention_plain(
        q, arena_k, arena_v, tables, positions))


def test_flash_gpt_step_counts_the_kernels_formulas():
    """The port's GPT with flash attention: the dense products plus
    B1-B3's formulas, causal pairs, exactly."""
    net = GPTForCausalLM(_gpt_cfg(GPTConfig, attn_impl="flash"),
                         device="cpu", seed=0)
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.AdamW(parameters=net.parameters(), device="cpu"),
              GPTPretrainingCriterion())
    reg = StatRegistry()
    m.attach_step_meter(sm.StepMeter(peak_flops=1e12, registry=reg))
    ids = np.random.RandomState(1).randint(0, 512, (2, 64))
    m.train_batch([ids], [ids])
    t, s, h, v, layers = 2 * 64, 64, 256, 512, 2
    pairs = fa.attention_pairs(s, s, True)
    flash = layers * (4 + 6 + 8) * 2 * h * pairs / 2    # B*H*D = 2*h
    assert reg.get("train.flops_per_step") == \
        3 * t * (12 * layers * h * h + h * v) + flash


def test_a_loop_counts_each_iteration_where_xla_counts_its_body_once():
    """The deliberate difference (ROADMAP.md): XLA's cost analysis counts
    a loop's body once, the port's counter every iteration that runs."""
    import jax
    import jax.numpy as jnp
    n, trips = 128, 8
    ja = jnp.ones((n, n), jnp.float32)

    def jloop(x):
        return jax.lax.fori_loop(0, trips, lambda i, y: y @ x, x)

    ref = jsm.compiled_flops(jloop, ja)
    assert n ** 3 <= ref < 2 * n ** 3          # one body's product

    def loop(x):
        y = x
        for _ in range(trips):
            y = y @ x
        return y

    assert sm.compiled_flops(loop, torch.ones(n, n)) == trips * n ** 3
