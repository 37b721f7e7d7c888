"""The port's span tracer, Chrome export and flight recorder against the
JAX package's: the same nested spans, exceptions, ring overflow and
threads give equal records apart from times (names, depth, attrs, the
``error`` attr, ``dropped``); ``to_trace_events`` of the same records
gives equal JSON; the port's flight dump has the reference's header and
line kinds and the reference's ``tools/trace_export.py`` converts it;
``dump_if_armed`` is gated as in the reference; a ``Model``'s trace
nests ``jit/compile`` inside its first ``train/step``."""
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from paddle_tpu.observability import export as jexport  # noqa: E402
from paddle_tpu.observability import flight as jflight  # noqa: E402
from paddle_tpu.observability import tracer as jtracer  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.core.monitor import StatRegistry  # noqa: E402
from paddle_tpu_torch.observability import export, flight, tracer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracing_off_between_tests():
    yield
    for mod in (tracer, jtracer):
        mod.disable()
        mod.default_tracer().clear()
    for mod in (flight, jflight):
        mod.disarm()
        mod.default_recorder().clear()


def _scenario(mod, t):
    """Nested spans, attrs, an exception, a set_attr, and two threads,
    through ``span_always`` of the standalone tracer ``t``."""
    with t.span_always("outer", {"k": 1}):
        with t.span_always("inner") as s:
            s.set_attr("n", 2)
        with pytest.raises(ValueError):
            with t.span_always("boom", {"a": "b"}):
                raise ValueError("x")
    started = threading.Event()
    release = threading.Event()

    def other():
        with t.span_always("thread-b"):
            started.set()
            release.wait(10)

    th = threading.Thread(target=other, name="worker-b")
    with t.span_always("thread-a"):
        th.start()
        started.wait(10)
        release.set()
        th.join(10)
    for i in range(7):
        with t.span_always(f"s{i}", {"i": i}):
            pass


def _shape(spans):
    return [(s["name"], s["depth"], s["attrs"], s["thread"]
             if s["thread"] == "worker-b" else "main") for s in spans]


@pytest.mark.parametrize("capacity", [4, 9, 64])
def test_same_spans_give_equal_records(capacity):
    j = jtracer.SpanTracer(capacity=capacity)
    t = tracer.SpanTracer(capacity=capacity)
    _scenario(jtracer, j)
    _scenario(tracer, t)
    assert _shape(t.spans()) == _shape(j.spans())
    assert t.dropped == j.dropped
    assert sorted(t.spans()[0]) == sorted(j.spans()[0])
    for s in t.spans():
        assert s["dur_ns"] >= 0 and s["ts_ns"] > 0
    assert _shape(t.drain()) == _shape(j.drain())
    assert t.spans() == [] == j.spans()
    t.clear()
    assert t.dropped == 0


def test_gate_enable_disable_and_capacity_follow_the_reference():
    assert not tracer.is_enabled()
    assert tracer.span("a") is tracer.span("b", {"k": 1}) is tracer.NOOP_SPAN
    with tracer.NOOP_SPAN as s:
        assert s.set_attr("x", 1) is s
    assert tracer.default_tracer().spans() == []
    for mod in (tracer, jtracer):
        mod.enable(capacity=3)
        for i in range(5):
            with mod.span(f"e{i}"):
                pass
    assert _shape(tracer.default_tracer().spans()) == \
        _shape(jtracer.default_tracer().spans())
    assert tracer.default_tracer().capacity == 3
    obs.enable()
    assert flight.is_armed() and tracer.is_enabled()
    obs.disable()
    assert not flight.is_armed() and not tracer.is_enabled()
    tracer.enable(capacity=tracer.DEFAULT_CAPACITY)
    assert tracer.DEFAULT_CAPACITY == jtracer.DEFAULT_CAPACITY


def test_trace_events_and_chrome_export_match(tmp_path):
    t = tracer.SpanTracer()
    _scenario(tracer, t)
    spans = t.spans()
    assert json.dumps(export.to_trace_events(spans, pid=7)) == \
        json.dumps(jexport.to_trace_events(spans, pid=7))
    assert json.dumps(export.to_trace_events(spans, process_name="p")) == \
        json.dumps(jexport.to_trace_events(spans, process_name="p"))
    path = str(tmp_path / "t.json")
    assert export.export_chrome_trace(path, tracer=t) == len(spans)
    doc = export.load_chrome_trace(path)
    assert doc["otherData"]["clock"] == "perf_counter_ns"
    assert doc["otherData"]["dropped_spans"] == 0
    xev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xev] == [s["name"] for s in spans]
    assert export.export_chrome_trace(path, tracer=t, drain=True) == \
        len(spans)
    assert t.spans() == []


def _read_flight(path):
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert lines[0]["schema"] == flight.SCHEMA == jflight.SCHEMA
    assert lines[-1]["kind"] == "stats"
    return lines


def test_flight_dump_matches_the_reference_layout(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TPU_COHORT_GEN", "2")
    dumps = []
    for mod, smod in ((flight, tracer), (jflight, jtracer)):
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            rec.record("tick", {"i": i})
        assert [e["i"] for e in rec.events()] == [2, 3, 4]
        reg = StatRegistry()
        reg.add("c", 2)
        reg.observe("h", 1.5)
        t = smod.SpanTracer()
        with t.span_always("s"):
            pass
        d = tmp_path / mod.__name__.split(".")[0]
        dumps.append(_read_flight(rec.dump("unit", directory=str(d),
                                           registry=reg, tracer=t)))
    mine, ref = dumps
    assert sorted(mine[0]) == sorted(ref[0])
    assert mine[0]["process_index"] == 3 and mine[0]["process_count"] == 4
    assert mine[0]["cohort_generation"] == 2 and mine[0]["reason"] == "unit"
    assert [line.get("kind") for line in mine] == \
        [line.get("kind") for line in ref]
    assert mine[-1]["stats"] == {"c": 2}
    assert mine[-1]["histograms"]["h"]["count"] == 1
    assert sorted(mine[-2]) == sorted(ref[-2])          # the span line


def test_reference_trace_export_tool_converts_a_port_dump(tmp_path):
    tracer.enable()
    with tracer.span("a"):
        with tracer.span("b", {"x": 1}):
            pass
    rec = flight.FlightRecorder()
    rec.record("marker", {"x": 1})
    dump = rec.dump("unit_test", directory=str(tmp_path))
    out = str(tmp_path / "t.json")
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "trace_export.py"), dump,
         "-o", out], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    doc = json.load(open(out))
    assert doc["otherData"]["flight_reason"] == "unit_test"
    names = {e.get("name") for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"a", "b"} <= names


def test_dump_if_armed_gating_and_signal_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    flight.disarm()
    assert flight.dump_if_armed("nope") is None
    assert list(tmp_path.iterdir()) == []
    flight.arm()
    path = flight.dump_if_armed("yes")
    assert path is not None and os.path.exists(path)
    assert flight.default_recorder().last_dump_path == path
    os.remove(path)
    # the signal dump chains onto what was installed, and is removed
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    h = flight.install_signal_dump(signal.SIGUSR1)
    try:
        signal.raise_signal(signal.SIGUSR1)
    finally:
        h.uninstall()
        signal.signal(signal.SIGUSR1, prev)
    assert seen == [signal.SIGUSR1]
    (dump,) = tmp_path.iterdir()
    lines = _read_flight(str(dump))
    assert lines[0]["reason"] == f"signal_{int(signal.SIGUSR1)}"
    assert any(line.get("kind") == "signal" for line in lines)


def test_model_trace_nests_compile_inside_the_first_step(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2))
    m = P.Model(net, device="cpu")
    m.prepare(P.optimizer.SGD(learning_rate=0.01,
                              parameters=net.parameters(), device="cpu"),
              torch.nn.functional.mse_loss)
    obs.enable()
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype("float32")
    y = rng.randn(4, 2).astype("float32")
    for _ in range(3):
        m.train_batch([x], [y])
    path = str(tmp_path / "trace.json")
    assert export.export_chrome_trace(path) >= 4
    xev = [e for e in export.load_chrome_trace(path)["traceEvents"]
           if e["ph"] == "X"]
    steps = [e for e in xev if e["name"] == "train/step"]
    compiles = [e for e in xev if e["name"] == "jit/compile"]
    assert len(steps) == 3 and len(compiles) == 1
    first = min(steps, key=lambda e: e["ts"])
    c = compiles[0]
    assert c["args"] == {"fn": "train_step", "depth": 1}
    assert first["ts"] <= c["ts"]
    assert c["ts"] + c["dur"] <= first["ts"] + first["dur"] + 1e-3
