"""The port's own hot-path span check (the counterpart of the JAX
package's PTA005 span-fastpath rule, which scans only ``paddle_tpu``):
an AST scan of the port's hot-path modules (``serving/``,
``hapi/model.py``, ``ops/``, ``core/graphs.py``) finds no
``span_always(`` and no span built outside the module-level ``span()``
gate (``Span(...)`` or ``SpanTracer(...)`` directly), and every span
there is opened through ``span()``. JAX-free."""
import ast
from pathlib import Path

import pytest

from paddle_tpu_torch.observability import tracer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"
HOT = sorted([*(PORT / "serving").rglob("*.py"), PORT / "hapi" / "model.py",
              *(PORT / "ops").rglob("*.py"), PORT / "core" / "graphs.py"])
#: names whose call builds a span without the gate
UNGATED = {"span_always", "Span", "SpanTracer"}


def findings(source: str, filename: str = "<src>"):
    """``(line, what)`` for every ungated span construction in
    ``source``."""
    out = []
    for node in ast.walk(ast.parse(source, filename=filename)):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        if name in UNGATED:
            out.append((node.lineno, f"{name}( bypasses the span() gate"))
    return out


def spans_opened(source: str):
    """The names of the spans ``source`` opens through ``span()``."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.append(node.args[0].value)
    return names


@pytest.mark.parametrize("path", HOT, ids=lambda p: str(p.relative_to(ROOT)))
def test_hot_path_modules_build_no_ungated_span(path):
    assert findings(path.read_text(), str(path)) == []


def test_the_scan_catches_a_planted_violation():
    bad = ("from paddle_tpu_torch.observability import tracer\n"
           "def hot(x):\n"
           "    with tracer.default_tracer().span_always('op/hot'):\n"
           "        return x\n"
           "def hot2(x):\n"
           "    with tracer.Span(tracer.default_tracer(), 'op/x'):\n"
           "        return x\n")
    assert [line for line, _ in findings(bad)] == [3, 6]
    good = ("from paddle_tpu_torch.observability import tracer\n"
            "def hot(x):\n"
            "    with tracer.span('op/hot', {'n': 1}):\n"
            "        return x\n")
    assert findings(good) == []


def test_the_instrumented_spans_are_the_references():
    opened = set()
    for path in HOT:
        opened.update(spans_opened(path.read_text()))
    assert {"serving/queue_put", "serving/form_batch",
            "serving/execute_batch", "serving.llm/prefill",
            "serving.llm/decode_tick", "serving.llm/spec_tick",
            "train/step", "jit/compile",
            "observability/cost_analysis"} <= opened


def test_the_disabled_gate_returns_the_shared_noop():
    assert not tracer.is_enabled()
    assert tracer.span("a") is tracer.span("b", {"k": 1}) is \
        tracer.NOOP_SPAN
    assert tracer.NOOP_SPAN.__slots__ == ()
