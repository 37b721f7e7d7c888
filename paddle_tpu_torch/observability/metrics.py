"""Prometheus text exposition (format 0.0.4) of a ``StatRegistry``
(counterpart of ``paddle_tpu/observability/metrics.py``; the same
families, names, escaping and text, so a dashboard's queries carry
over).

* scalar stats made by ``add()`` are ``counter``s with a ``_total``
  suffix; stats made by ``set()`` are ``gauge``s
* histograms are ``summary`` families: ``{quantile="0.5|0.95|0.99"}``
  samples and ``_sum`` and ``_count``
* labeled gauges (``set_labeled``) give one sample per label set, with
  the label values escaped as the exposition format says

Names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots become
underscores) and namespaced ``paddle_tpu_``. Everything renders from one
``snapshot()``, so a scrape never mixes two points in time.
``CONTENT_TYPE`` is what an HTTP ``/metricsz`` serves.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from ..core import monitor as _monitor

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def sanitize_metric_name(name: str, namespace: str = "paddle_tpu") -> str:
    """Dotted stat name -> legal Prometheus metric name."""
    out = _NAME_OK.sub("_", name)
    if namespace:
        out = f"{namespace}_{out}"
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def format_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if isinstance(v, int) or f.is_integer():
        return str(int(f))
    return repr(f)


def _labels_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_NAME_OK.sub("_", k)}="{escape_label_value(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


def render_prometheus(registry: Optional["_monitor.StatRegistry"] = None,
                      namespace: str = "paddle_tpu") -> str:
    """Render one registry as Prometheus text exposition."""
    reg = registry if registry is not None else _monitor.default_registry()
    snap = reg.snapshot()
    lines: List[str] = []
    emitted: set = set()  # family names already given HELP/TYPE

    def family(metric: str, kind: str, help_text: str) -> bool:
        """Emit HELP/TYPE once per family; False if the sanitized name
        collided with an already-emitted family (sample is skipped — two
        families with one name would be invalid exposition)."""
        if metric in emitted:
            return False
        emitted.add(metric)
        lines.append(f"# HELP {metric} {escape_help(help_text)}")
        lines.append(f"# TYPE {metric} {kind}")
        return True

    stats: Dict = snap["stats"]
    kinds: Dict = snap["kinds"]
    for name in sorted(stats):
        kind = kinds.get(name, "gauge")
        metric = sanitize_metric_name(name, namespace)
        if kind == "counter" and not metric.endswith("_total"):
            metric += "_total"
        if family(metric, kind, f"paddle_tpu stat `{name}`"):
            lines.append(f"{metric} {format_value(stats[name])}")

    for name in sorted(snap["histograms"]):
        s = snap["histograms"][name]
        metric = sanitize_metric_name(name, namespace)
        if not family(metric, "summary", f"paddle_tpu histogram `{name}`"):
            continue
        for q, key in _QUANTILES:
            lines.append(f'{metric}{{quantile="{q}"}} '
                         f"{format_value(s[key])}")
        lines.append(f"{metric}_sum {format_value(s['sum'])}")
        lines.append(f"{metric}_count {format_value(s['count'])}")

    for name in sorted(snap["labeled"]):
        metric = sanitize_metric_name(name, namespace)
        if not family(metric, "gauge", f"paddle_tpu labeled gauge `{name}`"):
            continue
        for labels, value in sorted(snap["labeled"][name].items()):
            lines.append(f"{metric}{_labels_str(labels)} "
                         f"{format_value(value)}")

    return "\n".join(lines) + "\n" if lines else ""
