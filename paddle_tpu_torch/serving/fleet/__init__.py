"""The serving fleet's control plane (counterpart of
``paddle_tpu/serving/fleet``): :mod:`migrate` (zero-loss serving:
:class:`FleetMigrator` moves running sequences, paged KV pages included,
between replicas for a park or a weight roll, and replays
:class:`SequenceJournal`-tracked sequences onto survivors after a kill)
and :mod:`swap` (:class:`WeightSwapper` rolls a committed, health-stamped
checkpoint across the replicas: migrate out, quiesce, swap, probe,
readmit, with a rollback on a failed probe). All of it is host-side
control, off the request path.

``autoscaler`` (``SLO``, ``Autoscaler``, ``AutoscalerConfig``) and
``replay`` (``TraceRecorder``, ``TraceReplayer``, ``load_trace``,
``save_trace``, ``synthesize_trace``) are the next slice of the port
(ROADMAP.md queue A8, slice 24): importing them raises."""
from . import migrate, swap
from .migrate import (MANIFEST_VERSION, FleetMigrator, JournalRecord,
                      SequenceJournal, SequenceManifest, prompt_fingerprint)
from .swap import SwapError, WeightSwapper

__all__ = ["migrate", "swap", "MANIFEST_VERSION", "FleetMigrator",
           "JournalRecord", "SequenceJournal", "SequenceManifest",
           "prompt_fingerprint", "SwapError", "WeightSwapper"]

_SLICE_24 = {"autoscaler": ("SLO", "Autoscaler", "AutoscalerConfig"),
             "replay": ("TraceRecorder", "TraceReplayer", "load_trace",
                        "save_trace", "synthesize_trace")}


def __getattr__(name):
    for module, names in _SLICE_24.items():
        if name == module or name in names:
            raise NotImplementedError(
                f"serving.fleet.{name} ({module}.py) is not ported yet: "
                f"ROADMAP.md queue A8, slice 24")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
