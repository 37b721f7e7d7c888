"""The port's ``core.monitor.StatRegistry`` and ``observability.metrics``
against the JAX package's: the same sequence of ``add``/``set``/
``set_labeled``/``observe`` calls (seeded with NumPy) gives equal
``snapshot()``s and IDENTICAL Prometheus text, including the JAX
package's own cases (special values, name collisions, set-then-add,
label escaping) and a threaded snapshot that never tears."""
import math
import threading
import time

import numpy as np
import pytest

from paddle_tpu.core import monitor as jmon
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.core import monitor as tmon
from paddle_tpu_torch.observability import metrics as tmetrics

NAMES = ["req.count", "queue-depth", "lat.ms", "a.b", "a_b", "x:y",
         "9lives", "serving.llm.mfu", "depth", "tokens_total"]
LABELS = [{"state": "busy"}, {"state": 'bu"sy\n'}, {"b": "2", "a": "1"},
          {"a": "1", "b": "2"}, {"path\\": "c:\\tmp"}, {"k.v": "x y"}]
VALUES = [0, 1, 3, -2, 0.25, 1e-9, 123456789012, 2.5e17, float("nan"),
          float("inf"), float("-inf"), 7.0]


def _ops(seed, n=300):
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["add", "set", "set_labeled", "observe",
                           "observe_small"])
        name = NAMES[rng.randint(len(NAMES))]
        value = VALUES[rng.randint(len(VALUES))]
        if kind == "observe":
            value = float(rng.standard_normal()) * 10 ** rng.randint(-3, 4)
        if kind == "observe_small":
            value = float(rng.randint(0, 100))
        ops.append((kind, name, LABELS[rng.randint(len(LABELS))], value))
    return ops


def _apply(reg, ops):
    for kind, name, labels, value in ops:
        if kind == "add":
            reg.add(name, value)
        elif kind == "set":
            reg.set(name, value)
        elif kind == "set_labeled":
            reg.set_labeled(name, labels, value)
        elif kind == "observe":
            reg.observe("h." + name, value)
        else:
            reg.observe("small." + name, value, max_samples=5)


def _canon(x):
    """NaN-safe structural form (NaN != NaN defeats ==)."""
    if isinstance(x, dict):
        return {repr(k): _canon(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_give_equal_snapshots_and_identical_text(seed):
    ops = _ops(seed)
    j, t = jmon.StatRegistry(), tmon.StatRegistry()
    _apply(j, ops)
    _apply(t, ops)
    assert _canon(t.snapshot()) == _canon(j.snapshot())
    assert _canon(t.stats()) == _canon(j.stats())
    assert _canon(t.histograms()) == _canon(j.histograms())
    for name in NAMES:
        assert _canon(t.labeled(name)) == _canon(j.labeled(name))
        assert _canon(t.histogram("h." + name)) == \
            _canon(j.histogram("h." + name))
        assert t.quantile("small." + name, 0.9) == \
            j.quantile("small." + name, 0.9)
    text = tmetrics.render_prometheus(t)
    assert text == jmetrics.render_prometheus(j)
    assert text == tmetrics.render_prometheus(t, namespace="paddle_tpu")
    assert tmetrics.render_prometheus(t, namespace="ns") == \
        jmetrics.render_prometheus(j, namespace="ns")
    # reset of one name, then of everything, as the reference's
    for reg in (j, t):
        reg.reset(NAMES[0])
    assert tmetrics.render_prometheus(t) == jmetrics.render_prometheus(j)
    for reg in (j, t):
        reg.reset()
    assert tmetrics.render_prometheus(t) == "" == \
        jmetrics.render_prometheus(j)


def test_the_references_own_cases_render_identically():
    def case(reg):
        reg.add("req.count", 3)
        reg.set("queue-depth", 7)
        for v in (1.0, 2.0, 3.0, 4.0):
            reg.observe("lat.ms", v)
        reg.set_labeled("slots", {"state": 'bu"sy\n'}, 4)
        reg.set("depth", 2)
        reg.add("depth", 1)           # still a gauge: first writer wins
        reg.set("a.b", 1)
        reg.set("a_b", 2)             # collides with a.b: skipped
        reg.set("nan", float("nan"))
        reg.set("inf", float("inf"))
        reg.set("ninf", float("-inf"))
    j, t = jmon.StatRegistry(), tmon.StatRegistry()
    case(j)
    case(t)
    text = tmetrics.render_prometheus(t)
    assert text == jmetrics.render_prometheus(j)
    assert "paddle_tpu_req_count_total 3" in text
    assert "# TYPE paddle_tpu_depth gauge" in text
    assert "paddle_tpu_depth 3" in text
    assert text.count("# TYPE paddle_tpu_a_b gauge") == 1
    assert r'paddle_tpu_slots{state="bu\"sy\n"} 4' in text
    assert "paddle_tpu_nan NaN" in text and "paddle_tpu_inf +Inf" in text
    for v in (float("nan"), float("inf"), float("-inf"), 3.0, 0.25, 7,
              1e-30, 2 ** 60):
        assert tmetrics.format_value(v) == jmetrics.format_value(v)
    for name in ("a.b", "9x", "x-y z", ""):
        assert tmetrics.sanitize_metric_name(name) == \
            jmetrics.sanitize_metric_name(name)
    assert tmetrics.escape_label_value('a\\"\n') == \
        jmetrics.escape_label_value('a\\"\n')
    assert tmetrics.escape_help("h\\\n") == jmetrics.escape_help("h\\\n")
    assert tmetrics.CONTENT_TYPE == jmetrics.CONTENT_TYPE


def test_module_functions_and_print_stats(capsys):
    reg = tmon.default_registry()
    reg.reset("test_torch_obs.g")
    tmon.stat_set_labeled("test_torch_obs.g", {"k": "v"}, 3)
    assert reg.labeled("test_torch_obs.g") == {(("k", "v"),): 3}
    tmon.stat_observe("test_torch_obs.h", 2.0, max_samples=3)
    assert tmon.stat_quantile("test_torch_obs.h", 0.5) == 2.0
    for name in ("test_torch_obs.g", "test_torch_obs.h"):
        reg.reset(name)
    j, t = jmon.StatRegistry(), tmon.StatRegistry()
    _apply(j, _ops(7, 40))
    _apply(t, _ops(7, 40))
    t.print_stats()
    tout = capsys.readouterr().out
    j.print_stats()
    assert tout == capsys.readouterr().out and "STAT " in tout
    assert tmon.device_memory_stats("cpu") == {}


def test_threaded_writes_never_tear_a_snapshot():
    reg = tmon.StatRegistry()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            reg.observe("h", 1.0)
            reg.add("c", 1)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for th in threads:
        th.start()
    snaps = 0
    try:
        deadline = time.time() + 0.5
        while time.time() < deadline:
            snap = reg.snapshot()
            if "h" in snap["histograms"]:
                h = snap["histograms"]["h"]
                assert h["sum"] == h["count"], snap
                snaps += 1
    finally:
        stop.set()
        for th in threads:
            th.join(10)
    assert snaps > 0
    assert not any(th.is_alive() for th in threads)
