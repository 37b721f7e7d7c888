"""The port's ``Router`` and ``Replica`` against the JAX package's (its
``tests/test_fleet.py`` park/unpark, kill, hot-swap and degraded-router
cases and ``tests/test_llm_disagg.py``'s router roles, disaggregated
routing and healthz role cases, read as specs): ``RouterConfig``'s
refusals word for word, the replica lifecycle, a park and unpark costing
one restart, resurrection after a kill, graceful degradation when the
restart budget runs out, a weight roll that is version-tagged, gives the
new weights' tokens and captures nothing, its rollback, role-aware
dispatch, the prefill->decode handoff over one shared host prefix store,
the phase fallback and no handoff without a shared store; every token
list equal to the JAX package's for the same weights. Tiny model: vocab
64, hidden 32, 2 layers, 4 heads, spread weights; every replica on the
CPU (``device="cpu"``)."""
import time

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
from paddle_tpu.serving.llm import PrefixStore as JPrefixStore  # noqa: E402
from paddle_tpu.serving import request as jrequest  # noqa: E402
from paddle_tpu.serving import router as jrouter  # noqa: E402
from paddle_tpu.utils import resilience as jresilience  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.distributed.elastic import RestartBudget  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import (  # noqa: E402
    commit_checkpoint, swap_eligible)
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.observability.metrics import \
    render_prometheus  # noqa: E402
from paddle_tpu_torch.serving import request as trequest  # noqa: E402
from paddle_tpu_torch.serving.fleet import (SwapError,  # noqa: E402
                                            WeightSwapper)
from paddle_tpu_torch.serving.llm import (LLMEngine,  # noqa: E402
                                          LLMEngineConfig, PrefixStore)
from paddle_tpu_torch.serving.replica import Replica  # noqa: E402
from paddle_tpu_torch.serving.request import EngineKilled  # noqa: E402
from paddle_tpu_torch.serving.router import (NoHealthyReplicas,  # noqa: E402
                                             Router, RouterConfig,
                                             llm_replica_factory)
from paddle_tpu_torch.utils import resilience  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
NEW = 6
LLM = dict(num_slots=2, max_seq=64, max_queue=64, warmup=False,
           default_max_new_tokens=4)
DISAGG = dict(num_slots=2, max_seq=64, warmup=False)
MAX_NEW = 10


def _prompts():
    """test_llm_disagg.py's prompts: two short (never cacheable), three
    long enough to insert and reuse a 16-token block."""
    rng = np.random.RandomState(7)
    return [rng.randint(0, 64, size=n).astype(np.int32)
            for n in (5, 12, 20, 24, 33)]


PROMPTS = _prompts()


def _spread(sd, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = (a * 0.3 if v.ndim > 1 else a * 0.1 + (
            1.0 if "norm" in k and k.endswith("weight") else 0.0)
        ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    """Two weight sets (the old and the new of a roll): the JAX model
    carrying each, and each as NumPy."""
    out = []
    for seed in (0, 1):
        paddle.seed(seed)
        jm = JGPT(JGPTConfig(**MODEL))
        jm.eval()
        sd = _spread(jm.state_dict(), seed)
        jm.set_state_dict(sd)
        out.append((jm, sd))
    return out


def _port_model(sd):
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    return pm


@pytest.fixture(scope="module")
def pmodel(weights):
    return _port_model(weights[0][1])


@pytest.fixture(scope="module")
def jtok(weights):
    """The JAX slot engine's greedy tokens: PROMPT under each weight set,
    and PROMPTS under the first (test_llm_disagg.py's baseline)."""
    out = {}
    for i, (jm, _) in enumerate(weights):
        eng = JLLMEngine(jm, JConfig(**LLM), registry=JStatRegistry())
        try:
            out[i] = eng.submit(PROMPT, max_new_tokens=NEW).result(
                timeout=120)["tokens"]
        finally:
            eng.drain(timeout=60)
    eng = JLLMEngine(weights[0][0], JConfig(num_slots=4, max_seq=64,
                                            warmup=False),
                     registry=JStatRegistry())
    try:
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        out["prompts"] = [r.result(timeout=120)["tokens"] for r in reqs]
    finally:
        eng.drain(timeout=60)
    return out


def _router(model_factory, n=2, **rcfg):
    rcfg.setdefault("health_interval", 0.05)
    reg = StatRegistry()
    return Router(llm_replica_factory(model_factory, LLMEngineConfig(**LLM)),
                  RouterConfig(num_replicas=n, kind="llm", **rcfg),
                  registry=reg, device="cpu")


def _wait_for(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture
def fault_spec(monkeypatch):
    def arm(spec):
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
        resilience._reset_fault_injector_for_tests()
    yield arm
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    resilience._reset_fault_injector_for_tests()
    jresilience._reset_fault_injector_for_tests()


# -- the config and the taxonomy ---------------------------------------------------

def test_role_taxonomy_equals_the_jax_package():
    assert trequest.REPLICA_ROLES == jrequest.REPLICA_ROLES
    assert (trequest.PHASE_PREFILL, trequest.PHASE_DECODE) == \
        (jrequest.PHASE_PREFILL, jrequest.PHASE_DECODE)


@pytest.mark.parametrize("kw", [
    dict(kind="llm", num_replicas=2, roles=("prefill",)),
    dict(kind="llm", num_replicas=2, roles=("prefill", "verifier")),
    dict(kind="llm", num_replicas=2, roles=("prefill", "prefill")),
    dict(kind="classifier", num_replicas=2, roles=("prefill", "decode")),
    dict(kind="llm", num_replicas=2, roles=("prefill", "decode"),
         prefill_threshold=0),
    dict(kind="llm", num_replicas=0),
    dict(kind="batch", num_replicas=1),
], ids=["one_role_per_replica", "invalid_role", "no_decode_phase",
        "roles_need_llm", "threshold", "no_replicas", "kind"])
def test_router_config_refusals_equal_the_jax_package(kw):
    with pytest.raises(ValueError) as ref:
        jrouter.RouterConfig(**kw)
    with pytest.raises(ValueError) as got:
        RouterConfig(**kw)
    assert str(got.value) == str(ref.value)


def test_router_config_defaults_equal_the_jax_package():
    got, ref = RouterConfig(kind="llm"), jrouter.RouterConfig(kind="llm")
    for k in ("num_replicas", "kind", "health_interval", "max_restarts",
              "restart_backoff", "restart_backoff_cap", "auto_resurrect",
              "stat_prefix", "roles", "prefill_threshold", "handoff",
              "handoff_timeout", "recovery"):
        assert getattr(got, k) == getattr(ref, k), k
    assert RouterConfig().recovery is False            # classifier


# -- the replica -------------------------------------------------------------------

class _FakeEngine:
    """Just the surface a Replica reads."""

    def __init__(self):
        import threading
        from concurrent.futures import Future
        self._queue = []
        self._stopped = threading.Event()
        self.draining = False
        self.killed = None
        self._future = Future

    def submit(self, *a, **k):
        f = self._future()
        self.last = f
        return f

    def begin_drain(self):
        self.draining = True
        self._stopped.set()

    def kill(self, reason):
        self.killed = reason
        return [{"req_id": 1, "phase": "decode", "tokens": 2}]


def test_replica_lifecycle_and_accounting():
    engines = []

    def factory(r):
        assert r.device == torch.device("cpu")
        engines.append(_FakeEngine())
        return engines[-1]
    budget = RestartBudget(1, backoff=0.0)
    rep = Replica(0, factory, device="cpu", restart_budget=budget,
                  unhealthy_queue_depth=2)
    assert rep.state == "HEALTHY" and rep.admissible
    f = rep.submit([1, 2])
    assert rep.outstanding == 1 and rep.stats()["dispatched"] == 1
    f.set_result(None)
    assert rep.outstanding == 0 and rep.stats()["completed"] == 1
    rep.pause()
    assert not rep.admissible and rep.healthz()["healthy"]   # not a reason
    with pytest.raises(trequest.EngineDraining, match="paused"):
        rep.submit([1])
    rep.resume()
    engines[0]._queue.extend([0, 0, 0])
    h = rep.healthz()
    assert not h["healthy"] and "queue_depth 3 > 2" in h["reasons"][0]
    engines[0]._queue.clear()
    rep.mark_unhealthy("sentinel")
    assert not rep.admissible
    assert rep.healthz()["reasons"] == ["marked_unhealthy: sentinel"]
    assert rep.kill("chaos") and rep.state == "DEAD"
    assert rep.kill("again") is False
    assert engines[0].killed == "replica 0: chaos"
    assert rep.last_kill_records[0]["tokens"] == 2
    assert rep.resurrect() and rep.state == "HEALTHY"
    assert rep.stats()["restarts"] == 1 and len(engines) == 2
    assert rep.drain(1.0) and rep.state == "DEAD"
    assert rep.resurrect() is False                    # budget spent
    with pytest.raises(NotImplementedError, match="A10"):
        Replica(1, factory, device="cpu", mesh=object())


# -- park and unpark ---------------------------------------------------------------

def test_park_unpark_roundtrip_costs_one_restart(pmodel, jtok):
    router = _router(lambda r: pmodel)
    try:
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
        assert router.park(1) is True
        assert router.park(1) is False
        assert router.fleet_snapshot()["parked"] == [1]
        assert _wait_for(
            lambda: router.fleet_snapshot()["active_replicas"] == 1)
        hz = router.healthz()
        assert hz["status"] == "ok" and hz["parked"] == [1]
        assert hz["degraded_replicas"] == 0
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
        assert router.budget.used == 0
        assert router.unpark(1) is True
        assert router.unpark(1) is False
        assert router.budget.used == 1
        assert router.replicas[1].state == "HEALTHY"
        assert router.fleet_snapshot()["active_replicas"] == 2
    finally:
        router.drain(timeout=60)


def test_parked_replica_not_resurrected_by_sweep(pmodel):
    router = _router(lambda r: pmodel)
    try:
        router.park(1)
        assert _wait_for(lambda: router.replicas[1].state == "DEAD")
        time.sleep(0.3)                                # several sweeps
        assert router.replicas[1].state == "DEAD"
        assert router.budget.used == 0
        assert router.registry.stats().get("serving.router.degraded",
                                           0) == 0
    finally:
        router.drain(timeout=60)


def test_router_shares_the_supervisor_budget_class(pmodel):
    router = _router(lambda r: pmodel, n=1)
    try:
        assert isinstance(router.budget, RestartBudget)
    finally:
        router.drain(timeout=60)


# -- the hard kill -----------------------------------------------------------------

def test_kill_fails_queued_and_inflight_with_engine_killed(pmodel):
    engine = LLMEngine(pmodel, LLMEngineConfig(**dict(LLM, num_slots=1)))
    try:
        futs = [engine.submit(PROMPT, max_new_tokens=8) for _ in range(3)]
        engine.kill("test chaos")
        assert engine.was_killed
        for f in futs:
            with pytest.raises(EngineKilled):
                f.result(timeout=30)
        with pytest.raises(EngineKilled):
            engine.submit(PROMPT)
    finally:
        engine.drain(timeout=30)


def test_router_resurrects_killed_replica(pmodel, jtok):
    router = _router(lambda r: pmodel, restart_backoff=0.01)
    try:
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
        assert router.replicas[0].kill("test chaos") is True
        assert _wait_for(lambda: router.replicas[0].state == "HEALTHY",
                         timeout=30)
        assert router.budget.used >= 1
        assert router.registry.stats()["serving.router.resurrections"] >= 1
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
    finally:
        router.drain(timeout=60)


# -- the live weight swap ----------------------------------------------------------

def test_swap_requires_paused_admission(pmodel):
    engine = LLMEngine(pmodel, LLMEngineConfig(**LLM))
    try:
        with pytest.raises(RuntimeError, match="pause_admission"):
            engine.swap_weights({})
    finally:
        engine.drain(timeout=30)


def test_classifier_router_refused():
    class _Classifier:
        kind = "classifier"
    with pytest.raises(ValueError, match="LLMEngine"):
        WeightSwapper(_Classifier())


def test_eligibility_gates(weights, pmodel, tmp_path):
    ok, why = swap_eligible(str(tmp_path / "nope"))
    assert not ok
    sick = str(tmp_path / "sick")
    commit_checkpoint({"model": _port_model(weights[1][1]).state_dict()},
                      sick, healthy=False, reason="probe failed")
    ok, why = swap_eligible(sick)
    assert not ok and "health" in why.lower()
    router = _router(lambda r: pmodel, n=1)
    try:
        with pytest.raises(SwapError, match="refusing"):
            WeightSwapper(router).roll(sick)
        assert router.registry.stats()["fleet.swap.refused"] == 1
    finally:
        router.drain(timeout=60)


def test_roll_is_version_tagged_bitwise_and_recompile_free(weights, jtok,
                                                            tmp_path):
    router = _router(lambda r: _port_model(weights[0][1]), n=1)
    try:
        before = router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)
        assert before["weights_version"] == 0
        assert before["tokens"] == jtok[0] != jtok[1]
        ckpt = str(tmp_path / "ckpt-new")
        commit_checkpoint({"model": _port_model(weights[1][1]).state_dict()},
                          ckpt, healthy=True, step=1)
        engine = router.replicas[0].engine
        misses0 = engine.cache.stats()["misses"]
        report = WeightSwapper(router).roll(ckpt)
        assert report["swapped"] == [0] and report["aborted"] is False
        assert report["versions"] == {0: 1}
        assert engine.cache.stats()["misses"] == misses0   # no new program
        assert engine.weights_version == 1
        after = router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)
        assert after["weights_version"] == 1
        assert after["tokens"] == jtok[1]              # the new weights'
        stats = router.registry.stats()
        assert stats["fleet.swap.replicas_swapped"] == 1
        assert stats["serving.llm.replica0.weight_swaps"] == 1
        assert stats["serving.llm.replica0.weight_swap_compiles"] == 0
        assert router.registry.quantile("fleet.swap.downtime_ms",
                                        0.95) > 0.0
        for name in ("fleet.swap.eligible_ms", "fleet.swap.load_ms",
                     "serving.llm.replica0.weight_swap_ms"):
            assert router.registry.histogram(name)["count"] == 1
    finally:
        router.drain(timeout=60)


def test_failed_swap_rolls_back_to_prior_weights(weights, jtok, tmp_path,
                                                 fault_spec):
    router = _router(lambda r: _port_model(weights[0][1]), n=1)
    try:
        ckpt = str(tmp_path / "ckpt-new")
        commit_checkpoint({"model": _port_model(weights[1][1]).state_dict()},
                          ckpt, healthy=True, step=1)
        fault_spec("weight_swap:1:fail")
        report = WeightSwapper(router).roll(ckpt)
        assert report["aborted"] is True
        assert report["rolled_back"] == 0 and report["swapped"] == []
        assert router.registry.stats()["fleet.swap.rollbacks"] == 1
        after = router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)
        assert after["tokens"] == jtok[0]              # the old weights
        assert router.replicas[0].state == "HEALTHY"
    finally:
        router.drain(timeout=60)


# -- the degraded router -----------------------------------------------------------

def test_budget_exhaustion_degrades_gracefully(pmodel, jtok):
    router = _router(lambda r: pmodel, max_restarts=0)
    try:
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
        router.replicas[0].kill("chaos: unrecoverable")
        assert _wait_for(lambda: router.registry.stats().get(
            "serving.router.degraded", 0) == 1, timeout=30)
        hz = router.healthz()
        assert hz["status"] == "degraded"
        assert hz["degraded_replicas"] == 1 and hz["budget_remaining"] == 0
        assert router.submit(PROMPT, max_new_tokens=NEW).result(
            timeout=120)["tokens"] == jtok[0]
        assert router.replicas[0].state == "DEAD"
        text = render_prometheus(router.registry)
        assert "paddle_tpu_serving_router_degraded 1" in text
        assert 'replica="0"' in text and 'replica="1"' in text
        assert "paddle_tpu_serving_router_replica_p95_ms" in text
        assert "paddle_tpu_serving_router_replica_parked" in text
        assert len(router.registries()) == 1           # one shared registry
    finally:
        router.drain(timeout=60)


def test_no_admissible_replica_raises(pmodel):
    router = _router(lambda r: pmodel, n=1)
    try:
        router.park(0)
        with pytest.raises(NoHealthyReplicas):
            router.submit(PROMPT)
        assert router.registry.stats()[
            "serving.router.rejected_no_replica"] == 1
    finally:
        router.drain(timeout=60)


# -- the disaggregated fleet -------------------------------------------------------

def _disagg(model, store, reg, roles=("prefill", "decode")):
    return Router(
        llm_replica_factory(lambda r: model, LLMEngineConfig(**DISAGG),
                            roles=roles, prefix_store=store),
        RouterConfig(kind="llm", num_replicas=2, roles=roles,
                     prefill_threshold=32, health_interval=0.2,
                     auto_resurrect=False),
        registry=reg, device="cpu")


@pytest.fixture(scope="module")
def jfleet(weights):
    """The JAX package's disaggregated fleet on the long prompt: its
    tokens and counters."""
    reg = JStatRegistry()
    store = JPrefixStore(capacity_bytes=64 << 20, registry=reg)
    router = jrouter.Router(
        jrouter.llm_replica_factory(lambda r: weights[0][0],
                                    JConfig(**DISAGG),
                                    roles=("prefill", "decode"),
                                    prefix_store=store),
        jrouter.RouterConfig(kind="llm", num_replicas=2,
                             roles=("prefill", "decode"),
                             prefill_threshold=32, health_interval=0.2,
                             auto_resurrect=False),
        registry=reg)
    try:
        toks = router.submit(PROMPTS[4], max_new_tokens=MAX_NEW).result(
            timeout=120)["tokens"]
    finally:
        router.drain(timeout=60)
    return toks, reg.stats()


@pytest.fixture(scope="module")
def fleet(pmodel):
    reg = StatRegistry()
    store = PrefixStore(capacity_bytes=64 << 20, registry=reg)
    router = _disagg(pmodel, store, reg)
    yield router, reg, store
    router.drain(timeout=60)


def test_short_prompt_goes_to_the_decode_replica(fleet, jtok):
    router, reg, _ = fleet
    toks = router.submit(PROMPTS[0], max_new_tokens=MAX_NEW).result(
        timeout=120)["tokens"]
    assert toks == jtok["prompts"][0]
    assert reg.get("serving.router.dispatched_role_decode") >= 1
    assert reg.get("serving.router.dispatched_phase_decode") >= 1


def test_long_prompt_hands_off_kv(fleet, jtok, jfleet):
    router, reg, store = fleet
    toks = router.submit(PROMPTS[4], max_new_tokens=MAX_NEW).result(
        timeout=120)["tokens"]
    jtoks, jstats = jfleet
    assert toks == jtoks == jtok["prompts"][4]
    assert reg.get("serving.router.handoff_prefills") >= 1
    assert reg.get("serving.router.dispatched_role_prefill") >= 1
    assert reg.get("serving.router.dispatched_phase_prefill") >= 1
    # the decode replica reused the prefill replica's exported head
    key = "serving.llm.replica1.prefix.reused_tokens"
    assert reg.get(key) == jstats[key] >= 32
    assert store.stats()["entries"] >= 1
    assert store.stats()["pinned"] == 0


def test_observability_surfaces_roles(fleet):
    router, _, _ = fleet
    assert router.stats()["roles"] == ["prefill", "decode"]
    assert {r["role"] for r in router.healthz()["replicas"]} == \
        {"prefill", "decode"}
    assert [r.engine.role for r in router.replicas] == ["prefill", "decode"]
    assert router.replicas[1].engine.stats()["role"] == "decode"


def test_phase_fallback_when_the_decode_replica_drains(fleet, jtok):
    """Availability beats placement; runs last on the module's fleet."""
    router, reg, _ = fleet
    router.replicas[1].engine.begin_drain()
    toks = router.submit(PROMPTS[1], max_new_tokens=MAX_NEW).result(
        timeout=120)["tokens"]
    assert toks == jtok["prompts"][1]
    assert reg.get("serving.router.phase_fallback") >= 1


def test_no_shared_store_disables_handoff(pmodel, jtok):
    reg = StatRegistry()
    router = _disagg(pmodel, None, reg)
    try:
        toks = router.submit(PROMPTS[4], max_new_tokens=MAX_NEW).result(
            timeout=120)["tokens"]
    finally:
        router.drain(timeout=60)
    assert toks == jtok["prompts"][4]
    assert reg.get("serving.router.handoff_prefills") == 0
    assert reg.get("serving.router.dispatched_role_prefill") >= 1


def test_llm_engine_reports_its_role(pmodel):
    eng = LLMEngine(pmodel, LLMEngineConfig(num_slots=2, max_seq=32,
                                            warmup=False, role="decode"),
                    registry=StatRegistry())
    try:
        assert eng.role == "decode" and eng.stats()["role"] == "decode"
    finally:
        eng.drain(timeout=30)
