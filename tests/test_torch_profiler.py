"""The port's ``paddle_tpu_torch.profiler`` on the CPU (the cases of the
JAX package's ``tests/test_profiler_monitor.py``): a ``Profiler`` sets
and clears ``_ACTIVE`` (the gate the op funnel reads), records the
funnel's ``op::<name>`` ranges, the ``RecordEvent`` and span ranges and
its ``ProfilerStep#<n>`` markers, writes a Chrome trace into the
directory ``export`` returns, calls ``on_trace_ready`` at ``stop`` and
keeps step times; ``timer_only`` records no trace; the fluid-style
functions behave as the reference's."""
import json
import os

import numpy as np
import torch

torch.set_num_threads(2)

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch import profiler  # noqa: E402
from paddle_tpu_torch.core import device as _device  # noqa: E402
from paddle_tpu_torch.core import monitor  # noqa: E402
from paddle_tpu_torch.observability import tracer  # noqa: E402
from paddle_tpu_torch.ops import dispatch  # noqa: E402


def _names(path):
    doc = json.load(open(path))
    return {e.get("name") for e in doc["traceEvents"]}


def test_profiler_gates_the_funnel_and_writes_a_trace(tmp_path):
    saved = _device._CURRENT[0]
    P.set_device("cpu")
    ready = []
    try:
        log_dir = str(tmp_path / "prof")
        assert dispatch._PROF_ACTIVE is profiler._ACTIVE
        assert not profiler.is_profiling()
        tracer.enable()
        with profiler.Profiler(log_dir=log_dir,
                               on_trace_ready=ready.append) as prof:
            assert profiler.is_profiling() and dispatch._PROF_ACTIVE[0]
            x = P.to_tensor(np.ones((8, 8), np.float32))
            with profiler.RecordEvent("my_region"):
                y = P.matmul(x, x)
            with tracer.span("my/span"):
                (y + y).numpy()
            prof.step()
            P.tanh(y).numpy()
            prof.step()
        assert not profiler.is_profiling() and not dispatch._PROF_ACTIVE[0]
    finally:
        tracer.disable()
        tracer.default_tracer().clear()
        _device._CURRENT[0] = saved
    assert ready == [prof]
    assert prof.export() == log_dir
    assert os.path.dirname(prof.trace_path) == log_dir
    names = _names(prof.trace_path)
    assert {"op::matmul_v2", "my_region", "my/span", "ProfilerStep#0",
            "ProfilerStep#1", "ProfilerStep#2"} <= names
    assert any(n.startswith("op::tanh") for n in names)
    assert "steps=2" in prof.step_info()
    assert len(prof._step_times) == 2
    table = prof.torch_profiler.key_averages()
    assert any(e.key == "op::matmul_v2" for e in table)


def test_summary_timer_only_and_restart(tmp_path, capsys):
    with profiler.Profiler(timer_only=True) as prof:
        assert profiler.is_profiling()
        for _ in range(3):
            prof.step()
    assert prof.torch_profiler is None and prof.trace_path is None
    assert "steps=3" in prof.step_info()
    prof.summary()
    assert "steps=3" in capsys.readouterr().out
    assert profiler.Profiler(timer_only=True).step_info() == \
        paddle.profiler.Profiler(timer_only=True).step_info()
    # a span outside a profile enters no range
    tracer.enable()
    try:
        with tracer.span("quiet") as s:
            assert s._ann is None
    finally:
        tracer.disable()
        tracer.default_tracer().clear()


def test_fluid_style_functions(tmp_path):
    log_dir = str(tmp_path / "p2")
    with profiler.profiler(log_dir=log_dir):
        assert profiler.is_profiling()
        (torch.ones(4) + 1).sum()
    assert not profiler.is_profiling()
    assert [f for f in os.listdir(log_dir) if f.endswith(".json")]
    profiler.start_profiler(log_dir=log_dir)
    profiler.start_profiler(log_dir=log_dir)        # idempotent
    assert profiler.is_profiling()
    profiler.stop_profiler()
    profiler.stop_profiler()
    assert not profiler.is_profiling()
    with profiler.cuda_profiler("out", "csv"):
        pass
    assert profiler.reset_profiler() is None
    ev = profiler.RecordEvent("manual")
    ev.begin()
    ev.end()
    ev.end()                                        # no active range
    assert P.utils.Profiler is profiler.Profiler
    assert P.profiler is profiler


def test_monitor_cases_of_the_reference():
    reg = monitor.StatRegistry()
    assert reg.add("mem", 10) == 10
    assert reg.add("mem", 5) == 15
    reg.set("peak", 99.5)
    assert reg.get("peak") == 99.5
    assert reg.stats() == {"mem": 15, "peak": 99.5}
    reg.reset("mem")
    assert reg.get("mem") == 0
    reg.reset()
    assert reg.stats() == {}
    monitor.stat_add("test_torch_gauge", 3)
    monitor.stat_add("test_torch_gauge", 4)
    assert monitor.stat_get("test_torch_gauge") == 7
    monitor.default_registry().reset("test_torch_gauge")
