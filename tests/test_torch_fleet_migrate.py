"""The port's zero-loss serving against the JAX package's (its
``tests/test_fleet_migrate.py`` read as the spec): the resume-dedup
guard's four cases on both packages' requests, kill records and the
evacuation of an engine with recovery armed, a paged sequence exported
mid-stream and imported into a sibling engine (fp32 and int8 pages)
finishing with the JAX engine's undisturbed greedy tokens, manifests
crossing between the packages both ways, the refusal of cold,
other-version and other-geometry manifests, the ``seq_export``,
``seq_import`` and ``journal_write`` fault sites, the journal's ring,
and park, kill and weight roll through a 2-replica router, every stream
the JAX engine's. Tiny model: vocab 64, hidden 32, 2 layers, 4 heads,
8-token pages, spread weights (the init's greedy tokens repeat)."""
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.core.monitor import StatRegistry as JStatRegistry  # noqa: E402
from paddle_tpu.models import GPTConfig as JGPTConfig  # noqa: E402
from paddle_tpu.models import GPTForCausalLM as JGPT  # noqa: E402
from paddle_tpu.serving.fleet import \
    SequenceManifest as JSequenceManifest  # noqa: E402
from paddle_tpu.serving.llm import GenerationRequest as JRequest  # noqa: E402
from paddle_tpu.serving.llm import LLMEngine as JLLMEngine  # noqa: E402
from paddle_tpu.serving.llm import LLMEngineConfig as JConfig  # noqa: E402
from paddle_tpu.serving.llm import SamplingParams as JSampling  # noqa: E402
from paddle_tpu.serving.queue import BatchQueue as JBatchQueue  # noqa: E402
from paddle_tpu.serving.request import \
    TokenStreamDivergence as JDivergence  # noqa: E402
from paddle_tpu.utils import resilience as jresilience  # noqa: E402
from paddle_tpu_torch import framework_io  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.incubate.checkpoint import commit_checkpoint  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import (EngineKilled,  # noqa: E402
                                      TokenStreamDivergence)
from paddle_tpu_torch.serving.fleet import (MANIFEST_VERSION,  # noqa: E402
                                            SequenceJournal,
                                            SequenceManifest, WeightSwapper)
from paddle_tpu_torch.serving.llm import (GenerationRequest,  # noqa: E402
                                          LLMEngine, LLMEngineConfig,
                                          SamplingParams)
from paddle_tpu_torch.serving.queue import BatchQueue  # noqa: E402
from paddle_tpu_torch.serving.router import (Router,  # noqa: E402
                                             RouterConfig,
                                             llm_replica_factory)
from paddle_tpu_torch.utils import resilience  # noqa: E402

MODEL = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
             max_position_embeddings=128, hidden_dropout_prob=0.0,
             attention_dropout_prob=0.0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
N_NEW = 24
PAGED = dict(num_slots=2, max_seq=64, max_queue=64, warmup=False,
             kv_layout="paged", page_size=8, default_max_new_tokens=N_NEW)


def _spread(sd):
    rng = np.random.default_rng(0)
    out = {}
    for k, v in sd.items():
        a = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = (a * 0.3 if v.ndim > 1 else a * 0.1 + (
            1.0 if "norm" in k and k.endswith("weight") else 0.0)
        ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def weights():
    """The JAX model with spread weights, and those weights as NumPy."""
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    sd = _spread(jm.state_dict())
    jm.set_state_dict(sd)
    return jm, sd


def _port_model(sd):
    pm = GPTForCausalLM(GPTConfig(**MODEL), device="cpu").eval()
    pm.load_state_dict(framework_io.state_dict_from_reference(sd, "cpu"),
                       strict=True)
    return pm


@pytest.fixture(scope="module")
def pmodel(weights):
    return _port_model(weights[1])


@pytest.fixture(scope="module")
def jref(weights):
    """The JAX engine's undisturbed greedy stream of PROMPT on fp32 and
    on int8 pages."""
    out = {}
    for kvd in ("float32", "int8"):
        eng = JLLMEngine(weights[0], JConfig(**PAGED, kv_dtype=kvd),
                         registry=JStatRegistry())
        try:
            out[kvd] = eng.submit(PROMPT, max_new_tokens=N_NEW).result(
                timeout=120)["tokens"]
        finally:
            eng.drain(timeout=60)
    return out


def _cfg(**kw):
    return LLMEngineConfig(**dict(PAGED, **kw))


def _wait_for(pred, timeout=30.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _started(engine, **kw):
    """A streaming PROMPT request on ``engine`` with at least 3 tokens out,
    and the engine's admission paused (an export's precondition)."""
    req = engine.submit(PROMPT, max_new_tokens=N_NEW, stream=True, **kw)
    assert _wait_for(lambda: len(req.tokens) >= 3)
    engine.pause_admission()
    return req


@pytest.fixture
def fault_spec(monkeypatch):
    """Arm PADDLE_TPU_FAULT_SPEC (both packages read it); disarm after."""
    def arm(spec):
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
        resilience._reset_fault_injector_for_tests()
    yield arm
    monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC", raising=False)
    resilience._reset_fault_injector_for_tests()
    jresilience._reset_fault_injector_for_tests()


# -- the resume-dedup guard ----------------------------------------------------

def _guard_script(case, mk, divergence):
    """One of the JAX spec's four guard cases on a request made by
    ``mk``; returns what a client can observe."""
    req = mk()
    seen = {}
    if case == "replay_swallows_then_new_tokens_flow":
        emits = [req._emit(t) for t in (7, 8, 9)]
        req.begin_resume(1)
        seen["lens"] = (req.prompt_len, req.seq_len)
        emits += [req._emit(8), req._emit(9), req._emit(4)]
        seen["emits"] = emits
    elif case == "divergent_replay_fails_loudly":
        for t in (7, 8, 9):
            req._emit(t)
        req.begin_resume(0)
        seen["emits"] = [req._emit(7), req._emit(5)]
        with pytest.raises(divergence):
            req.result(timeout=5)
    elif case == "resume_ahead_of_stream_raises_gap_direction":
        req._emit(7)
        for n in (2, -1):
            with pytest.raises(divergence):
                req.begin_resume(n)
    else:
        for t in (7, 8):
            req._emit(t)
        req.begin_resume(2)
        seen["first"] = req.prompt_len
        req.begin_resume(1)
        seen["lens"] = (req.prompt_len, req.seq_len)
    seen["tokens"] = list(req.tokens)
    seen["prompt"] = [int(t) for t in req.prompt]
    return seen


@pytest.mark.parametrize("case", [
    "replay_swallows_then_new_tokens_flow", "divergent_replay_fails_loudly",
    "resume_ahead_of_stream_raises_gap_direction",
    "second_resume_rebuilds_from_original_prompt"])
def test_dedup_guard_case_equals_the_jax_request(case):
    got = _guard_script(case, lambda: GenerationRequest(
        PROMPT, SamplingParams(), stream=True), TokenStreamDivergence)
    ref = _guard_script(case, lambda: JRequest(
        PROMPT, JSampling(), stream=True), JDivergence)
    assert got == ref
    if case == "replay_swallows_then_new_tokens_flow":
        assert got["tokens"] == [7, 8, 9, 4]      # nothing duplicated
        assert got["lens"] == (len(PROMPT) + 1, len(PROMPT) + 3)
    if case == "divergent_replay_fails_loudly":
        assert got["emits"] == [True, False]
        assert got["tokens"] == [7, 8, 9]         # transcript untouched


# -- kill records ----------------------------------------------------------------

def test_fail_all_records_equal_the_jax_queue():
    def run(queue, mk, killed):
        q = queue(max_size=8)
        reqs = [mk() for _ in range(3)]
        for r in reqs:
            q.put(r, block=False)
        recs = q.fail_all(lambda: killed("gone"))
        return [(r["phase"], r["tokens"], r["req_id"] - reqs[0].req_id)
                for r in recs], reqs
    from paddle_tpu.serving.request import EngineKilled as JKilled
    got, reqs = run(BatchQueue, lambda: GenerationRequest(
        PROMPT, SamplingParams()), EngineKilled)
    ref, _ = run(JBatchQueue, lambda: JRequest(PROMPT, JSampling()), JKilled)
    assert got == ref == [("queued", 0, i) for i in range(3)]
    for r in reqs:
        with pytest.raises(EngineKilled):
            r.result(timeout=5)


def test_engine_kill_snapshots_queued_and_decode_phases(pmodel):
    eng = LLMEngine(pmodel, _cfg(num_slots=1), registry=StatRegistry())
    a = eng.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
    assert _wait_for(lambda: len(a.tokens) >= 1)
    b = eng.submit(PROMPT, max_new_tokens=4)          # queued behind a
    recs = {r["req_id"]: r for r in eng.kill("test kill")}
    assert recs[b.req_id]["phase"] == "queued"
    assert recs[a.req_id]["phase"] == "decode"
    assert recs[a.req_id]["tokens"] >= 1
    assert recs[a.req_id]["evacuated"] is False
    for r in (a, b):
        with pytest.raises(EngineKilled):
            r.result(timeout=30)
    assert eng._stopped.wait(timeout=30)


def test_kill_with_recovery_evacuates_instead_of_failing(pmodel):
    eng = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    journal = eng.enable_recovery()
    assert eng.enable_recovery() is journal           # idempotent
    a = eng.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
    assert _wait_for(lambda: len(a.tokens) >= 1)
    recs = eng.kill("test kill")
    dec = [r for r in recs if r["phase"] == "decode"]
    assert dec and all(r["evacuated"] for r in dec)
    assert eng._stopped.wait(timeout=30)
    evac = eng.take_evacuated()
    assert [r.req_id for r in evac] == [a.req_id]
    assert not a.future.done()                         # the router owns it
    assert eng.take_evacuated() == []                  # handed over once
    a.fail(EngineKilled("test cleanup"))
    journal.close()


# -- export and import ----------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_roundtrip_resumes_with_the_jax_engines_tokens(pmodel, jref,
                                                        kv_dtype):
    areg, breg = StatRegistry(), StatRegistry()
    a = LLMEngine(pmodel, _cfg(kv_dtype=kv_dtype), registry=areg)
    b = LLMEngine(pmodel, _cfg(kv_dtype=kv_dtype), registry=breg)
    try:
        assert a.supports_migration and b.supports_migration
        req = _started(a)
        mans = a.export_sequences(timeout=30)
        assert len(mans) == 1
        man = mans[0]
        assert man.version == MANIFEST_VERSION and not man.cold
        assert man.n_cached_tokens == len(PROMPT) + len(man.tokens) - 1
        # the JAX package's payload layout: [n, L, page, H, D] per leaf
        leaf = man.k_pages["q"] if kv_dtype == "int8" else man.k_pages
        assert isinstance(leaf, np.ndarray)
        assert leaf.shape == (2, 2, 8, 4, 8)
        assert b.import_sequence(man, timeout=30)
        # the client's one iterator, read from the start
        assert list(req.iter_tokens(timeout=120)) == jref[kv_dtype]
        assert req.finish_reason == "length"
        stats = breg.stats()
        assert stats["serving.llm.migrated_in"] == 1
        assert stats["serving.llm.migrated_pages_copied"] == 2
        assert a._batcher.kv.pool.pages_in_use == 0    # the donor let go
        # each side's wall ms and the payload bytes it moved
        payload = sum(int(x.nbytes) for p in (man.k_pages, man.v_pages)
                      for x in (p.values() if isinstance(p, dict) else [p]))
        assert areg.stats()["serving.llm.seq_export_bytes"] == payload
        assert stats["serving.llm.seq_import_bytes"] == payload
        assert areg.histogram("serving.llm.seq_export_ms")["count"] == 1
        assert breg.histogram("serving.llm.seq_import_ms")["count"] == 1
    finally:
        a.drain(timeout=30)
        b.drain(timeout=30)


def test_manifest_from_the_jax_engine_resumes_in_the_port(weights, pmodel,
                                                          jref):
    """A JAX engine's export, its page payload as it is, spliced into the
    port's engine under a port request carrying the streamed tokens."""
    ja = JLLMEngine(weights[0], JConfig(**PAGED), registry=JStatRegistry())
    b = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    try:
        jreq = ja.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
        assert _wait_for(lambda: len(jreq.tokens) >= 3)
        ja.pause_admission()
        jman = ja.export_sequences(timeout=30)[0]
        sig = b.decoder.prefix_sig(b._batcher.kv)
        assert tuple(jman.sig) == tuple(sig)
        req = GenerationRequest(PROMPT, SamplingParams(
            max_new_tokens=N_NEW), stream=True)
        for t in jman.tokens:
            req._emit(int(t))
        man = SequenceManifest(
            req, jman.prompt, jman.tokens, req.sampling,
            weights_version=jman.weights_version,
            n_cached_tokens=jman.n_cached_tokens,
            page_size=jman.page_size, sig=sig, k_pages=jman.k_pages,
            v_pages=jman.v_pages)
        assert b.import_sequence(man, timeout=30)
        assert list(req.iter_tokens(timeout=120)) == jref["float32"]
        jreq.fail(RuntimeError("moved to the port"))
    finally:
        ja.drain(timeout=30)
        b.drain(timeout=30)


def test_manifest_from_the_port_resumes_in_the_jax_engine(weights, pmodel,
                                                          jref):
    a = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    jb = JLLMEngine(weights[0], JConfig(**PAGED), registry=JStatRegistry())
    try:
        req = _started(a)
        man = a.export_sequences(timeout=30)[0]
        jreq = JRequest(PROMPT, JSampling(max_new_tokens=N_NEW),
                        stream=True)
        for t in man.tokens:
            jreq._emit(int(t))
        jsig = jb.decoder.prefix_sig(jb._batcher.kv)
        assert tuple(jsig) == tuple(man.sig)
        jman = JSequenceManifest(
            jreq, man.prompt, man.tokens, jreq.sampling,
            weights_version=man.weights_version,
            n_cached_tokens=man.n_cached_tokens, page_size=man.page_size,
            sig=jsig, k_pages=man.k_pages, v_pages=man.v_pages)
        assert jb.import_sequence(jman, timeout=30)
        assert list(jreq.iter_tokens(timeout=120)) == jref["float32"]
        req.fail(RuntimeError("moved to the JAX package"))
    finally:
        a.drain(timeout=30)
        jb.drain(timeout=30)


def test_import_refuses_mismatched_manifests(pmodel, jref):
    a = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    b = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    try:
        req = _started(a)
        man = a.export_sequences(timeout=30)[0]
        cold = SequenceManifest.for_queued(
            GenerationRequest(PROMPT, SamplingParams()))
        assert cold.cold and b.import_sequence(cold) is False
        man.weights_version += 1                       # other weights
        assert b.import_sequence(man) is False
        man.weights_version -= 1
        sig = man.sig
        man.sig = ("tampered",)                        # other geometry
        assert b.import_sequence(man) is False
        man.sig = sig
        man.version += 1                               # a newer layout
        assert b.import_sequence(man) is False
        man.version -= 1
        pool = b._batcher.kv.pool
        assert pool.pages_in_use == 0 and b._batcher.active == 0
        assert b.import_sequence(man, timeout=30)
        assert list(req.iter_tokens(timeout=120)) == jref["float32"]
    finally:
        a.drain(timeout=30)
        b.drain(timeout=30)


def test_export_and_import_fault_sites_degrade(pmodel, jref, fault_spec):
    a = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    b = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    try:
        req = _started(a)
        fault_spec("seq_export:1:fail")
        with pytest.raises(RuntimeError, match="seq_export"):
            a.export_sequences(timeout=30)
        mans = a.export_sequences(timeout=30)          # budget spent
        assert len(mans) == 1
        fault_spec("seq_import:1:fail")
        assert b.import_sequence(mans[0]) is False     # never raises
        assert b.import_sequence(mans[0], timeout=30)
        assert list(req.iter_tokens(timeout=120)) == jref["float32"]
    finally:
        a.drain(timeout=30)
        b.drain(timeout=30)


def test_control_call_after_the_worker_stopped_raises(pmodel):
    eng = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    eng.drain(timeout=30)
    with pytest.raises(EngineKilled):
        eng._run_on_worker(lambda: 1, timeout=5)
    assert eng.import_sequence(SequenceManifest.for_queued(
        GenerationRequest(PROMPT, SamplingParams()))) is False


# -- the journal -------------------------------------------------------------------

def _journal(**kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("flush_interval", 999.0)             # manual flushes
    kw.setdefault("registry", StatRegistry())
    return SequenceJournal(**kw)


def _req():
    return GenerationRequest(PROMPT, SamplingParams())


def test_journal_ring_is_bounded_and_lookup_sees_newest():
    j = _journal()
    try:
        reqs = [_req() for _ in range(6)]
        for r in reqs:
            r._emit(5)
        j.note(reqs)
        j.flush_pending()
        assert len(j) == 4
        assert j.lookup(reqs[0].req_id) is None        # the oldest left
        rec = j.lookup(reqs[-1].req_id)
        assert rec is not None and rec.tokens == [5]
        assert j._registry.get("serving.llm.journal.entries") == 4
    finally:
        j.close()


def test_journal_prunes_finished_requests():
    j = _journal()
    try:
        r = _req()
        r._emit(3)
        j.note([r])
        j.flush_pending()
        assert j.lookup(r.req_id) is not None
        r._finish("stop")
        j.note([r])
        j.flush_pending()
        assert j.lookup(r.req_id) is None
        assert j.snapshot() == []
    finally:
        j.close()


def test_journal_dropped_write_leaves_stale_records(fault_spec):
    j = _journal()
    try:
        r = _req()
        r._emit(3)
        j.note([r])
        j.flush_pending()
        fault_spec("journal_write:1:drop")
        r._emit(4)
        j.note([r])
        j.flush_pending()                              # a lost write
        assert j.lookup(r.req_id).tokens == [3]        # stale, usable
        j.note([r])
        j.flush_pending()
        assert j.lookup(r.req_id).tokens == [3, 4]
    finally:
        j.close()


def test_journal_failed_write_counts_errors(fault_spec):
    j = _journal()
    try:
        fault_spec("journal_write:1:fail")
        r = _req()
        r._emit(3)
        j.note([r])
        j.flush_pending()
        assert j.write_errors == 1
        assert j.lookup(r.req_id) is None
    finally:
        j.close()


def test_journal_flushes_off_the_worker(pmodel):
    """An engine with recovery armed journals its live request from its
    own flush thread: the record appears without a manual flush."""
    eng = LLMEngine(pmodel, _cfg(), registry=StatRegistry())
    journal = eng.enable_recovery()
    try:
        req = eng.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
        assert _wait_for(lambda: journal.lookup(req.req_id) is not None)
        rec = journal.lookup(req.req_id)
        assert rec.tokens == req.tokens[:len(rec.tokens)]
        assert journal._thread.name == "paddle-tpu-torch-seq-journal"
    finally:
        eng.drain(timeout=30)
    assert not journal._thread.is_alive()              # drain closed it


# -- the fleet ---------------------------------------------------------------------

def _router(model_factory, n=2, **rcfg):
    rcfg.setdefault("health_interval", 0.05)
    reg = StatRegistry()
    router = Router(llm_replica_factory(model_factory, _cfg()),
                    RouterConfig(num_replicas=n, kind="llm", **rcfg),
                    registry=reg, device="cpu")
    return router, reg


def test_park_migrates_the_live_stream_to_the_sibling(pmodel, jref):
    router, reg = _router(lambda r: pmodel)
    try:
        assert router.migrator is not None
        req = router.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
        assert _wait_for(lambda: len(req.tokens) >= 3)
        donor = max(router.replicas, key=lambda r: r.outstanding)
        assert router.park(donor.replica_id)
        assert list(req.iter_tokens(timeout=120)) == jref["float32"]
        stats = reg.stats()
        assert stats["fleet.migrate.sequences_exported"] >= 1
        assert stats.get("fleet.migrate.sequences_imported", 0) \
            + stats.get("fleet.migrate.sequences_replayed", 0) >= 1
        assert stats.get("fleet.migrate.sequences_failed", 0) == 0
        assert router.budget.used == 0                 # a park is free
    finally:
        router.drain(timeout=60)


def test_kill_replays_the_journaled_stream_on_the_survivor(pmodel, jref):
    router, reg = _router(lambda r: pmodel, restart_backoff=0.01)
    try:
        req = router.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
        assert _wait_for(lambda: len(req.tokens) >= 3)
        victim = max(router.replicas, key=lambda r: r.outstanding)
        assert victim.kill("chaos: test kill")
        assert victim.last_kill_records[0]["evacuated"] is True
        # the survivor re-prefills; the guard swallows what was streamed
        assert list(req.iter_tokens(timeout=120)) == jref["float32"]
        assert _wait_for(lambda: reg.stats().get(
            "fleet.migrate.sequences_recovered", 0) >= 1)
        assert sum(v for k, v in reg.stats().items()
                   if k.endswith(".stream_divergence")) == 0
        # the health loop resurrects the victim on the restart budget
        assert _wait_for(lambda: victim.state == "HEALTHY", timeout=60)
        assert router.budget.used == 1
    finally:
        router.drain(timeout=60)


def test_weight_roll_migrates_instead_of_draining(weights, jref, tmp_path):
    """Four pumps keep streams in flight through the roll (a model per
    replica, the same weights either side), so migrate-out finds live
    sequences; every stream is the JAX engine's."""
    sd = weights[1]
    router, reg = _router(lambda r: _port_model(sd))
    stop = threading.Event()
    done, rejected = [], []

    def pump():
        while not stop.is_set():
            try:
                r = router.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
                done.append(list(r.iter_tokens(timeout=120)))
            except Exception as e:  # paused or draining windows: retry
                rejected.append(repr(e))
                time.sleep(0.01)
    pumps = [threading.Thread(target=pump, daemon=True) for _ in range(4)]
    try:
        ckpt = str(tmp_path / "ckpt-step1")
        commit_checkpoint({"model": _port_model(sd).state_dict()}, ckpt,
                          healthy=True, step=1)
        swapper = WeightSwapper(router, reg, quiesce_timeout=60.0,
                                probe_timeout=60.0)
        for t in pumps:
            t.start()
        assert _wait_for(lambda: sum(
            r.outstanding for r in router.replicas) >= 2)
        report = swapper.roll(ckpt)
        stop.set()
        for t in pumps:
            t.join(timeout=150)
        assert not any(t.is_alive() for t in pumps)
        assert not report["aborted"]
        assert sorted(report["swapped"]) == [0, 1]
        assert report["versions"] == {0: 1, 1: 1}
        assert sum(report.get("migrated", {}).values()) >= 1
        assert done and all(t == jref["float32"] for t in done)
        assert reg.stats()["fleet.migrate.sequences_exported"] >= 1
    finally:
        stop.set()
        router.drain(timeout=60)


def test_a_capture_tallies_its_own_streams_launches_only(monkeypatch):
    """C12: replicas on one card capture in one worker thread while a
    sibling's worker replays. A launch recorded on a capturing stream
    goes to that capture's tally (added at every replay), whichever
    thread issues it (autograd records a captured backward from a thread
    of its own); a launch on any other stream goes to the wrapper's count
    at once; none is lost or counted twice. Streams are stood in for by
    thread names here (no card)."""
    from paddle_tpu_torch.core import graphs
    monkeypatch.setattr(graphs, "_stream_key",
                        lambda: threading.current_thread().name)

    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.launches_by_dtype = {}
    inside, go = threading.Event(), threading.Event()
    tallies = []

    def launch(n):
        for _ in range(n):
            graphs.note_launch(wrapper, "float32")

    def capture():
        with graphs._tallying("capture") as tally:
            launch(3)
            # the backward, from autograd's thread on the capture stream
            t = threading.Thread(target=launch, args=(2,), name="capture")
            t.start()
            t.join(10)
            inside.set()
            go.wait(10)
            launch(1)
        tallies.append(tally)
    t = threading.Thread(target=capture, name="capture")
    t.start()
    assert inside.wait(10)
    for _ in range(5):                              # a sibling's replays
        graphs._add_counts({wrapper: (2, {"float32": 2})})
    graphs.note_launch(wrapper)                     # and an eager launch
    go.set()
    t.join(10)
    assert wrapper.launches == 11
    assert wrapper.launches_by_dtype == {"float32": 10}
    assert tallies == [{wrapper: (6, {"float32": 6})}]
    assert graphs._TALLIES == {}
    graphs._add_counts(tallies[0])                  # the capture's replay
    assert wrapper.launches == 17


class _Replica:
    def __init__(self, rid, engine):
        self.replica_id, self.engine = rid, engine
        self.admissible, self.outstanding = True, 0


class _Engine:
    """A sibling that takes whatever it is offered, recording how."""

    def __init__(self, version):
        self.weights_version = version
        self.calls = []

    def import_sequence(self, man, timeout=None):
        self.calls.append("import")
        return man.weights_version == self.weights_version

    def resubmit_for_recovery(self, req, tokens):
        self.calls.append("replay")
        return True

    def resubmit(self, req):
        self.calls.append("requeue")
        return True


def _c13(migrator_cls, manifest_cls, request, sampling, registry):
    donor, sibling = _Engine(0), _Engine(1)

    class _Router:
        replicas = [_Replica(0, donor), _Replica(1, sibling)]
    mig = migrator_cls(_Router(), registry=registry)
    req = request(PROMPT, sampling())
    for t in (5, 6, 7):
        req._emit(t)
    man = manifest_cls(req, PROMPT, req.tokens, req.sampling,
                       weights_version=0, n_cached_tokens=10, page_size=8,
                       sig=("sig",), k_pages=np.zeros(1),
                       v_pages=np.zeros(1))
    return mig._place(man, exclude_id=0), donor.calls, sibling.calls


def test_c13_a_stream_never_replays_onto_other_weights():
    """C13: a live sequence (version 0) whose only sibling serves other
    weights (version 1, mid-roll). The JAX package's migrator replays it
    there, and with nothing left to verify the stream would go on under
    the new weights; the port's puts it back into its donor."""
    from paddle_tpu.serving.fleet import FleetMigrator as JFleetMigrator
    from paddle_tpu_torch.serving.fleet import FleetMigrator
    ref = _c13(JFleetMigrator, JSequenceManifest, JRequest, JSampling,
               JStatRegistry())
    assert ref == ("replayed", [], ["replay"])          # the JAX fault
    reg = StatRegistry()
    got = _c13(FleetMigrator, SequenceManifest, GenerationRequest,
               SamplingParams, reg)
    assert got == ("kept", ["import"], [])
    assert reg.get("fleet.migrate.sequences_kept") == 1


@pytest.fixture(scope="module")
def jref_new():
    """The JAX engine's stream of PROMPT under a second weight set."""
    paddle.seed(1)
    jm = JGPT(JGPTConfig(**MODEL))
    jm.eval()
    sd = {k: v * 0.5 for k, v in _spread(jm.state_dict()).items()}
    jm.set_state_dict(sd)
    eng = JLLMEngine(jm, JConfig(**PAGED), registry=JStatRegistry())
    try:
        toks = eng.submit(PROMPT, max_new_tokens=N_NEW).result(
            timeout=120)["tokens"]
    finally:
        eng.drain(timeout=60)
    return sd, toks


def test_roll_to_other_weights_gives_old_or_new_streams(weights, jref,
                                                        jref_new, tmp_path):
    """A roll to other weights under four pumps: every finished stream
    is the old weights' or the new weights' JAX stream, never a mix, and
    each carries its version."""
    new_sd, new_toks = jref_new
    assert new_toks != jref["float32"]
    router, reg = _router(lambda r: _port_model(weights[1]))
    stop = threading.Event()
    done = []

    def pump():
        while not stop.is_set():
            try:
                r = router.submit(PROMPT, max_new_tokens=N_NEW, stream=True)
                done.append((list(r.iter_tokens(timeout=120)),
                             r.result(timeout=5)["weights_version"]))
            except Exception:       # paused windows, retryable failures
                time.sleep(0.01)
    pumps = [threading.Thread(target=pump, daemon=True) for _ in range(4)]
    try:
        ckpt = str(tmp_path / "ckpt-new")
        commit_checkpoint({"model": _port_model(new_sd).state_dict()}, ckpt,
                          healthy=True, step=1)
        for t in pumps:
            t.start()
        assert _wait_for(lambda: sum(
            r.outstanding for r in router.replicas) >= 2)
        report = WeightSwapper(router, reg, quiesce_timeout=60.0,
                               probe_timeout=60.0).roll(ckpt)
        assert _wait_for(lambda: any(v == 1 for _, v in done))
        stop.set()
        for t in pumps:
            t.join(timeout=150)
        assert not any(t.is_alive() for t in pumps)
        assert sorted(report["swapped"]) == [0, 1]
        want = {0: jref["float32"], 1: new_toks}
        assert done and all(toks == want[v] for toks, v in done)
        assert {v for _, v in done} == {0, 1}
    finally:
        stop.set()
        router.drain(timeout=60)
