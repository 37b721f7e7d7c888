"""The host-plane substrate wired into the port's engines and ``Model``,
on the CPU: ``Model.attach_step_meter`` publishes ``train.mfu``,
``train.flops_per_step`` and ``train.step_ms`` with losses bitwise those
without a meter (dropout on: the count puts the generator back);
``LLMEngine(measure_mfu=True)``, slot and paged, publishes
``serving.llm.mfu`` and ``decode_flops_per_tick`` with tokens equal to
the unmetered run (greedy and sampled) and to the JAX package's engine;
``arm_preemption`` and ``install_drain_signal_handler`` drain ``Engine``
and ``LLMEngine`` as the reference's tests do (a real SIGTERM raised in
flight completes every admitted request, and an armed flight recorder
dumps the ``sigterm_drain`` event, spans and stats); the workers record
``engine_killed`` and ``llm_worker_death``; a failing ``fit`` records
``train_loop_exception``. Signal tests install first, raise, and
uninstall in ``finally``; every engine is drained under a timeout."""
import json
import signal
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.distributed.elastic import PreemptionGuard  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,  # noqa: E402
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.observability import flight, tracer  # noqa: E402
from paddle_tpu_torch.observability.stepmeter import StepMeter  # noqa: E402
from paddle_tpu_torch.serving import ExecutableCache  # noqa: E402
from paddle_tpu_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig)

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
ENGINE = dict(num_slots=4, max_seq=64, prefill_buckets=(8, 16), warmup=True)
LAYOUTS = {"slot": {}, "paged": {"kv_layout": "paged", "page_size": 4}}
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], list(range(1, 14)), [7])


@pytest.fixture(autouse=True)
def _observability_off_between_tests():
    yield
    obs.disable()
    tracer.default_tracer().clear()
    flight.default_recorder().clear()


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(
        {k: np.asarray(v._data) for k, v in jm.state_dict().items()},
        "cpu"), strict=True)
    return jm, pm


@pytest.fixture(scope="module")
def jax_tokens(models):
    eng = JLLMEngine(models[0], JConfig(**ENGINE), registry=JStatRegistry())
    try:
        reqs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        return [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        eng.drain(timeout=60)


def _serve(model, layout, sample=False, **kw):
    eng = LLMEngine(model, LLMEngineConfig(**ENGINE, **LAYOUTS[layout],
                                           **kw), cache=ExecutableCache())
    try:
        reqs = [eng.submit(p, max_new_tokens=10, do_sample=sample,
                           temperature=1.5, top_k=8) for p in PROMPTS]
        return [r.result(timeout=120)["tokens"] for r in reqs], eng
    finally:
        eng.drain(timeout=60)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_measure_mfu_publishes_and_leaves_the_tokens(models, jax_tokens,
                                                     layout):
    plain, _ = _serve(models[1], layout)
    metered, eng = _serve(models[1], layout, measure_mfu=True)
    assert metered == plain == jax_tokens
    st = eng.stats()["stats"]
    flops = st["serving.llm.decode_flops_per_tick"]
    assert flops > 0 and st["serving.llm.mfu"] > 0
    # at least the weights' products: 4 slots x (12 L h^2 + h V) MACs
    assert flops >= 4 * (12 * 2 * 32 * 32 + 32 * 64)
    assert "serving.llm.decode_flops_per_tick" not in plain
    sampled_plain, _ = _serve(models[1], layout, sample=True)
    sampled, _ = _serve(models[1], layout, sample=True, measure_mfu=True)
    assert sampled == sampled_plain


def _train(meter, steps=3):
    net = GPTForCausalLM(GPTConfig(
        vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
        max_position_embeddings=32, hidden_dropout_prob=0.1,
        attention_dropout_prob=0.0, attn_impl="flash"), device="cpu",
        seed=0)
    net.add_module("bn", P.nn.BatchNorm1D(4, device="cpu"))
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.AdamW(parameters=net.parameters(), device="cpu",
                                grad_clip=P.nn.ClipGradByGlobalNorm(1.0)),
              GPTPretrainingCriterion())
    reg = StatRegistry()
    ids = np.random.RandomState(0).randint(0, 64, (4, 32))
    P.seed(11)
    losses = []
    for i in range(steps):
        # "late": attached after the signature's first call (its capture)
        if meter and i == (1 if meter == "late" else 0):
            m.attach_step_meter(StepMeter(registry=reg, device="cpu"))
        losses.append(m.train_batch([ids], [ids])[0])
    return losses, reg, m


@pytest.mark.parametrize("when", ["first", "late"])
def test_step_meter_publishes_with_losses_bitwise_unchanged(when):
    plain, _, _ = _train(False)
    metered, reg, m = _train(True if when == "first" else "late")
    assert metered == plain
    assert reg.get("train.flops_per_step") > 0
    assert reg.get("train.mfu") > 0
    steps = 3 if when == "first" else 2
    assert reg.histogram("train.step_ms")["count"] == steps
    assert reg.histogram("train.mfu_pct")["count"] == steps
    assert m._train_step_fn["flops"] == reg.get("train.flops_per_step")
    assert m._step_meter.peak_flops == 1.0e12


def test_a_failing_fit_records_the_flight_event(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    net = torch.nn.Linear(2, 2)
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.SGD(parameters=net.parameters(), device="cpu"),
              torch.nn.functional.mse_loss)
    flight.arm()
    bad = [np.zeros((2, 3), np.float32), np.zeros((2, 2), np.float32)]
    with pytest.raises(RuntimeError):
        m.fit([bad], verbose=0)
    (ev,) = [e for e in flight.default_recorder().events()
             if e["kind"] == "train_loop_exception"]
    assert ev["iteration"] == 0 and "RuntimeError" in ev["error"]
    (dump,) = tmp_path.glob("flight_*.jsonl")
    header = json.loads(dump.read_text().splitlines()[0])
    assert header["reason"] == "train_loop_exception"


def _double(x):
    return x * 2


def _engine(fn=_double):
    return Engine(fn, EngineConfig(batch_buckets=(1, 2, 4), max_batch=4,
                                   max_batch_delay=0.01),
                  cache=ExecutableCache(), device="cpu")


def _read(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_engine_drains_on_a_real_sigterm_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x * 2

    prev = signal.getsignal(signal.SIGTERM)
    eng = _engine(slow)
    obs.enable()
    chain = eng.install_drain_signal_handler()
    try:
        futs = [eng.submit([np.full((1, 2), i, np.float32)])
                for i in range(5)]
        signal.raise_signal(signal.SIGTERM)
        assert eng.draining
        with pytest.raises(Exception):
            eng.submit([np.ones((1, 2), np.float32)])
        gate.set()
        assert eng._stopped.wait(30)
    finally:
        gate.set()
        chain.uninstall()
        eng.drain(30)
    assert signal.getsignal(signal.SIGTERM) == prev
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(1)[0],
                                      np.full((1, 2), 2 * i, np.float32))
    (dump,) = tmp_path.glob("flight_*.jsonl")
    lines = _read(dump)
    assert lines[0]["reason"] == "sigterm_drain"
    kinds = [line.get("kind") for line in lines]
    assert "sigterm_drain" in kinds and kinds[-1] == "stats"
    names = {line["name"] for line in lines if line.get("kind") == "span"}
    assert {"serving/queue_put", "serving/form_batch",
            "serving/execute_batch"} <= names
    assert lines[-1]["stats"] == {} or isinstance(lines[-1]["stats"], dict)


def test_engine_preemption_guard_and_chaining_either_order():
    sig = signal.SIGUSR1
    original = signal.getsignal(sig)
    for order in ("guard_first", "engine_first"):
        eng = _engine()
        if order == "guard_first":
            guard = PreemptionGuard(signals=(sig,))
            chain = eng.install_drain_signal_handler(signals=(sig,))
        else:
            chain = eng.install_drain_signal_handler(signals=(sig,))
            guard = PreemptionGuard(signals=(sig,))
        try:
            signal.raise_signal(sig)
            assert guard.preempted and eng.draining
        finally:
            if order == "guard_first":
                chain.uninstall()
                guard.uninstall()
            else:
                guard.uninstall()
                chain.uninstall()
            eng.drain(30)
        assert signal.getsignal(sig) == original
    eng = _engine()
    guard = PreemptionGuard(install=False)
    assert eng.arm_preemption(guard) is guard
    fut = eng.submit([np.ones((2, 2), np.float32)])
    guard.preempt()
    assert eng._stopped.wait(30)
    np.testing.assert_array_equal(fut.result(1)[0], np.full((2, 2), 2.0))
    assert eng.registry.get("serving.preemption_drains") == 1
    eng.drain(30)


def test_engine_kill_records_the_flight_event():
    gate = threading.Event()

    def slow(x):
        gate.wait(10)
        return x

    eng = _engine(slow)
    eng.submit([np.ones((1, 2), np.float32)])
    eng.kill("test")
    gate.set()
    assert eng._stopped.wait(30)
    (ev,) = [e for e in flight.default_recorder().events()
             if e["kind"] == "engine_killed"]
    assert ev["engine"] == "serving" and ev["reason"] == "test"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_llm_engine_drains_on_sigterm_and_on_the_guard(models, tmp_path,
                                                       monkeypatch, layout):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    cfg = dict(ENGINE, **LAYOUTS[layout])
    prev = signal.getsignal(signal.SIGTERM)
    eng = LLMEngine(models[1], LLMEngineConfig(**cfg),
                    cache=ExecutableCache())
    obs.enable()
    chain = eng.install_drain_signal_handler()
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=25, stream=True)
        queued = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
        it = req.iter_tokens(timeout=60)
        got = [next(it) for _ in range(3)]
        signal.raise_signal(signal.SIGTERM)
        assert eng.draining
        got += list(it)
        assert len(got) == 25                       # finished, not cut off
        assert [len(q.result(60)["tokens"]) for q in queued] == [6] * 4
        assert eng._stopped.wait(60)
    finally:
        chain.uninstall()
        eng.drain(timeout=60)
    assert signal.getsignal(signal.SIGTERM) == prev
    (dump,) = tmp_path.glob("flight_*.jsonl")
    lines = _read(dump)
    kinds = [line.get("kind") for line in lines]
    assert lines[0]["reason"] == "sigterm_drain" and "sigterm_drain" in kinds
    names = {line["name"] for line in lines if line.get("kind") == "span"}
    # (the warm-up's jit/compile spans ran before tracing was enabled)
    assert {"serving.llm/prefill", "serving.llm/decode_tick",
            "serving/queue_put"} <= names
    assert lines[-1]["stats"] == {} or isinstance(lines[-1]["stats"], dict)

    eng = LLMEngine(models[1], LLMEngineConfig(**cfg),
                    cache=ExecutableCache())
    guard = PreemptionGuard(install=False)
    eng.arm_preemption(guard)
    req = eng.submit([4, 5], max_new_tokens=8)
    guard._handler(signal.SIGTERM, None)     # what the real signal runs
    assert eng._stopped.wait(60) and eng.draining
    assert len(req.result(1)["tokens"]) == 8
    assert eng.registry.get("serving.llm.preemption_drains") == 1
    eng.drain(timeout=60)


def test_llm_worker_death_and_kill_record_flight_events(models):
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE),
                    cache=ExecutableCache())

    def boom():
        raise RuntimeError("tick failed")

    eng._batcher.tick = boom
    req = eng.submit([1, 2], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="LLM worker died"):
        req.result(60)
    assert eng._stopped.wait(60)
    (ev,) = [e for e in flight.default_recorder().events()
             if e["kind"] == "llm_worker_death"]
    assert "tick failed" in ev["error"]
    eng = LLMEngine(models[1], LLMEngineConfig(**ENGINE),
                    cache=ExecutableCache())
    eng.kill("test")
    assert eng._stopped.wait(60)
    assert any(e["kind"] == "engine_killed" and e["reason"] == "test"
               for e in flight.default_recorder().events())
