"""The port's SLO autoscaler and traffic replay
(``paddle_tpu_torch.serving.fleet.{autoscaler,replay}``) against the JAX
package's (``tests/test_fleet.py``'s autoscaler and replay cases read as
specs): both packages' ``Autoscaler`` driven by ``tick()`` over the same
snapshots of a fake router give the same decision records, park and
unpark calls and stats; ``synthesize_trace`` gives the JAX package's
records for the same seed; a trace saved by either package loads in the
other; the recorder on a port ``Router`` keeps accepted requests only; a
replay completes with 0 drops, also under a running autoscaler that
scales a 2-replica router up on a breach and back down when calm. Tiny
model (vocab 64, hidden 32, 2 layers, 4 heads) on the CPU."""
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.serving import fleet as jfleet  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import fleet as tfleet  # noqa: E402
from paddle_tpu_torch.serving.llm import LLMEngineConfig  # noqa: E402
from paddle_tpu_torch.serving.router import (NoHealthyReplicas,  # noqa: E402
                                             Router, RouterConfig,
                                             llm_replica_factory)

VOCAB = 64
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
PACKAGES = {"jax": (jfleet, JStatRegistry), "port": (tfleet, StatRegistry)}


class _FakeRouter:
    """``tests/test_fleet.py``'s fake: a snapshot the scenario mutates,
    park/unpark recording, and a registry of the package under test."""

    def __init__(self, registry, n=3, parked=()):
        self.replicas = list(range(n))
        self.registry = registry
        self._parked = set(parked)
        self.p95_ms = 0.0
        self.queue_depth = 0
        self.completed = 0
        self.rejected = 0.0
        self.lost = 0
        self.park_calls, self.unpark_calls = [], []

    def parked_ids(self):
        return sorted(self._parked)

    def park(self, rid):
        self._parked.add(rid)
        self.park_calls.append(rid)
        return True

    def unpark(self, rid):
        self._parked.discard(rid)
        self.unpark_calls.append(rid)
        return True

    def fleet_snapshot(self):
        reps = [{"replica": i, "parked": i in self._parked,
                 "admissible": i not in self._parked,
                 "outstanding": i, "queue_depth": 0}
                for i in self.replicas]
        return {"replicas": reps,
                "active_replicas": (len(self.replicas) - len(self._parked)
                                    - self.lost),
                "parked": self.parked_ids(),
                "queue_depth": self.queue_depth, "outstanding": 0,
                "p95_ms": self.p95_ms, "completed": self.completed,
                "rejected_no_replica": self.rejected, "degraded": 0,
                "budget_remaining": 3, "draining": False}


#: scenarios: (fake router's n, parked, config, steps); a step is the
#: fields to set on the fake (and "clock") before one tick
SCENARIOS = {
    "breach_hysteresis_then_scale_up": (3, (1, 2), {}, [
        dict(p95_ms=500.0, completed=10), dict(completed=20),
        dict(completed=30), dict(completed=40),
        dict(clock=11.0, completed=50)]),
    "stale_p95_is_not_a_breach": (3, (1, 2), {}, [
        dict(p95_ms=500.0, completed=10), {}, {}]),
    "queue_and_reject_axes_breach": (3, (1, 2), dict(
        breach_ticks=1, cooldown_s=0.0), [
        dict(queue_depth=9), dict(queue_depth=0, rejected=2.0)]),
    "calm_run_scales_down_to_min": (3, (), dict(
        calm_ticks=2, cooldown_s=0.0), [{}] * 9),
    "up_blocked_when_capacity_lost": (2, (), dict(
        breach_ticks=1, cooldown_s=0.0), [
        dict(lost=1, p95_ms=500.0, completed=5)]),
    "storm_then_calm": (2, (1,), dict(breach_ticks=2, calm_ticks=3,
                                      cooldown_s=1.0), [
        dict(p95_ms=900.0, completed=3), dict(completed=6, queue_depth=40),
        dict(clock=0.5, completed=9), dict(clock=1.5, completed=12),
        dict(clock=2.0, p95_ms=20.0, queue_depth=0, completed=15),
        dict(clock=2.5), dict(clock=3.0), dict(clock=3.5),
        dict(clock=4.0), dict(clock=4.5, rejected=1.0)]),
}


def _drive(pkg, name):
    fleet, Registry = PACKAGES[pkg]
    n, parked, cfg, steps = SCENARIOS[name]
    cfg = dict(dict(breach_ticks=2, calm_ticks=3, cooldown_s=10.0), **cfg)
    fake = _FakeRouter(Registry(), n, parked)
    clock = [0.0]
    sc = fleet.Autoscaler(fake, fleet.SLO(p95_ms=100.0, max_queue=8,
                                          min_replicas=1),
                          fleet.AutoscalerConfig(**cfg),
                          registry=fake.registry, clock=lambda: clock[0])
    decisions = []
    for step in steps:
        for k, v in step.items():
            if k == "clock":
                clock[0] = v
            else:
                setattr(fake, k, v)
        decisions.append(sc.tick())
    return (decisions, fake.park_calls, fake.unpark_calls,
            fake.registry.stats(), sc.stats())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_reference(name):
    jd, jpark, junpark, jstats, jsc = _drive("jax", name)
    td, tpark, tunpark, tstats, tsc = _drive("port", name)
    assert td == jd
    assert (tpark, tunpark) == (jpark, junpark)
    assert {k: tstats[k] for k in jstats} == jstats
    assert {k: tsc[k] for k in jsc} == jsc


def test_the_scenarios_decide_as_the_reference_tests_say():
    d = _drive("port", "breach_hysteresis_then_scale_up")
    assert [x["action"] for x in d[0]] == ["hold", "up", "hold", "hold",
                                           "up"]
    assert d[2] == [1, 2]
    d = _drive("port", "calm_run_scales_down_to_min")
    assert d[1] == [0, 1] and d[0][-1]["action"] == "hold"
    d = _drive("port", "up_blocked_when_capacity_lost")
    assert d[0][0]["action"] == "up_blocked"
    assert d[3]["fleet.autoscale.up_blocked"] == 1


@pytest.mark.parametrize("kw", [dict(min_replicas=0),
                                dict(min_replicas=3, max_replicas=2)])
def test_slo_validation_equals_the_reference(kw):
    for fleet, _ in PACKAGES.values():
        with pytest.raises(ValueError):
            fleet.SLO(**kw)


def test_autoscaler_refuses_more_than_the_shells():
    for fleet, Registry in PACKAGES.values():
        with pytest.raises(ValueError, match="replica shells"):
            fleet.Autoscaler(_FakeRouter(Registry(), 2),
                             fleet.SLO(max_replicas=5))
        with pytest.raises(ValueError):
            fleet.AutoscalerConfig(breach_ticks=0)


def test_up_timings_are_recorded():
    """The port's extra histograms: the unpark's ms, and from the breach
    run's first tick to the replica admitting (a fake clock: 3 s)."""
    fake = _FakeRouter(StatRegistry(), 2, (1,))
    clock = [0.0]
    sc = tfleet.Autoscaler(fake, tfleet.SLO(p95_ms=100.0, max_queue=8),
                           tfleet.AutoscalerConfig(breach_ticks=2),
                           registry=fake.registry, clock=lambda: clock[0])
    fake.p95_ms, fake.completed = 500.0, 1
    sc.tick()
    clock[0], fake.completed = 3.0, 2
    assert sc.tick()["action"] == "up"
    h = fake.registry.histogram("fleet.autoscale.breach_to_up_ms")
    assert h["count"] == 1 and h["max"] == pytest.approx(3000.0)
    assert fake.registry.histogram("fleet.autoscale.unpark_ms")["count"] == 1


# -- traces -------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((50, 20.0), dict(seed=3)), ((8, 2.5), dict(seed=0)),
    ((200, 400.0), dict(seed=11, prompt_len_range=(17, 900),
                        max_new_tokens=32)),
    ((1, 1.0), dict(seed=7, prompt_len_range=(5, 5)))])
def test_synthesized_traces_equal_the_reference(args, kw):
    t = tfleet.synthesize_trace(*args, **kw)
    assert t == jfleet.synthesize_trace(*args, **kw)
    assert [r["t"] for r in t] == sorted(r["t"] for r in t)
    assert t != tfleet.synthesize_trace(*args, **dict(kw, seed=kw["seed"]
                                                      + 1)) or args[0] == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_trace_saved_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    trace = tfleet.synthesize_trace(10, 50.0, seed=1)
    trace[3]["phase"] = "prefill"
    p = str(tmp_path / "storm.jsonl")
    PACKAGES[writer][0].save_trace(list(reversed(trace)), p)
    assert PACKAGES[reader][0].load_trace(p) == trace


def _tiny_model():
    return GPTForCausalLM(GPTConfig(
        vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
        max_position_embeddings=128, hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0), device="cpu", seed=0).eval()


@pytest.fixture(scope="module")
def model():
    return _tiny_model()


def _router(model, n=1, paged=False, **rcfg):
    rcfg.setdefault("health_interval", 0.05)
    cfg = LLMEngineConfig(num_slots=2, max_seq=64, max_queue=64,
                          warmup=False, default_max_new_tokens=4,
                          **(dict(kv_layout="paged", page_size=8) if paged
                             else {}))
    return Router(llm_replica_factory(lambda r: model, cfg),
                  RouterConfig(num_replicas=n, kind="llm", **rcfg),
                  registry=StatRegistry(), device="cpu")


def test_recorder_captures_accepted_requests_only(model):
    router = _router(model)
    try:
        rec = tfleet.TraceRecorder()
        router.set_trace_recorder(rec)
        router.submit(PROMPT, max_new_tokens=2).result(timeout=120)
        router.submit(PROMPT[:3], max_new_tokens=2).result(timeout=120)
        assert len(rec) == 2
        router.park(0)
        with pytest.raises(NoHealthyReplicas):
            router.submit(PROMPT)
        assert len(rec) == 2                        # rejects not recorded
        trace = rec.trace()
        assert trace[0]["t"] == 0.0 and trace[1]["t"] > 0.0
        assert [r["prompt_len"] for r in trace] == [len(PROMPT), 3]
        assert [r["max_new_tokens"] for r in trace] == [2, 2]
        assert [r["phase"] for r in trace] == [None, None]
    finally:
        router.drain(timeout=60)


def test_replay_completes_with_zero_drops(model):
    router = _router(model)
    try:
        trace = tfleet.synthesize_trace(6, 30.0, seed=2, max_new_tokens=2,
                                        prompt_len_range=(2, 6))
        rep = tfleet.TraceReplayer(router, trace, vocab=VOCAB,
                                   workers=4).run()
        assert (rep["offered"], rep["completed"], rep["dropped"]) == (6, 6, 0)
        assert rep["weights_versions"] == {0: 6}
        assert rep["latency_p95_ms"] >= rep["latency_p50_ms"] > 0.0
    finally:
        router.drain(timeout=60)


def _wait_for(pred, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def test_replay_under_the_autoscaler_scales_up_and_down(model):
    """A running autoscaler over 2 replicas starts at 1 (replica 1
    parked); a replayed storm breaches a 1 ms p95, so replica 1 is
    unparked (booted), and once calm one replica is parked again (its
    sequences migrate: paged replicas); no request is dropped."""
    router = _router(model, n=2, paged=True)
    try:
        sc = tfleet.Autoscaler(
            router, tfleet.SLO(p95_ms=1.0, max_queue=64, min_replicas=1),
            tfleet.AutoscalerConfig(interval_s=0.05, breach_ticks=1,
                                    calm_ticks=3, cooldown_s=0.3))
        with sc:
            assert router.parked_ids() == [1]
            trace = tfleet.synthesize_trace(16, 40.0, seed=0,
                                            max_new_tokens=4,
                                            prompt_len_range=(2, 12))
            rep = tfleet.TraceReplayer(router, trace, vocab=VOCAB,
                                       workers=8).run()
            assert _wait_for(lambda: sc.stats().get(
                "fleet.autoscale.scale_downs", 0) >= 1)
        stats = router.registry.stats()
        assert (rep["offered"], rep["completed"], rep["dropped"]) == \
            (16, 16, 0)
        assert rep["weights_versions"] == {0: 16}
        assert stats["fleet.autoscale.scale_ups"] >= 1
        assert router.registry.histogram(
            "fleet.autoscale.breach_to_up_ms")["count"] >= 1
        assert stats["serving.router.resurrections"] >= 1
        assert len(router.parked_ids()) == 1
    finally:
        router.drain(timeout=60)


def test_unparked_paged_replica_admits_again(model):
    """A park of a paged replica pauses its admission while its sequences
    migrate; the port's unpark lifts the pause, so the booted replica
    takes traffic again (the JAX package's stays paused, so its unparked
    paged replicas never admit: a fault of the reference's, tests/
    test_fleet.py covers only slot replicas)."""
    router = _router(model, n=2, paged=True)
    try:
        assert router.replicas[1].engine.supports_migration
        assert router.park(1) and router.replicas[1].paused
        assert _wait_for(lambda: router.replicas[1].state == "DEAD")
        assert router.unpark(1) is True
        assert not router.replicas[1].paused
        assert router.replicas[1].admissible
        assert router.fleet_snapshot()["active_replicas"] == 2
        reqs = [router.submit(PROMPT, max_new_tokens=2) for _ in range(4)]
        assert all(len(r.result(timeout=120)["tokens"]) == 2 for r in reqs)
        assert router.replicas[1].stats()["dispatched"] >= 1
    finally:
        router.drain(timeout=60)
