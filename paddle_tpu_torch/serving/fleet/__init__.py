"""The serving fleet's control plane (counterpart of
``paddle_tpu/serving/fleet``), closing the loop between the telemetry
the stack publishes (registry gauges, health sweeps, flight events) and
the levers it has (Router park/unpark, budgeted resurrection, admission
pause, checkpoint health stamps):

* :class:`SLO` / :class:`Autoscaler` (:mod:`autoscaler`) — a controller
  thread polling :meth:`Router.fleet_snapshot` against a declared SLO,
  scaling the replica set with hysteresis and a cooldown;
* :class:`WeightSwapper` (:mod:`swap`) — rolls a committed,
  health-stamped checkpoint across the replicas: migrate out, quiesce,
  swap, probe, readmit, with a rollback on a failed probe;
* :mod:`migrate` — zero-loss serving: :class:`FleetMigrator` moves
  running sequences (paged KV pages included) between replicas for a
  park or a roll, and replays :class:`SequenceJournal`-tracked sequences
  onto survivors after a kill;
* :mod:`replay` — record and synthesize request traces and replay them
  with arrival-time fidelity.

All of it is host-side control, off the request path."""
from . import autoscaler, migrate, replay, swap
from .autoscaler import SLO, Autoscaler, AutoscalerConfig
from .migrate import (MANIFEST_VERSION, FleetMigrator, JournalRecord,
                      SequenceJournal, SequenceManifest, prompt_fingerprint)
from .replay import (TraceRecorder, TraceReplayer, load_trace, save_trace,
                     synthesize_trace)
from .swap import SwapError, WeightSwapper

__all__ = ["autoscaler", "migrate", "replay", "swap", "SLO", "Autoscaler",
           "AutoscalerConfig", "MANIFEST_VERSION", "FleetMigrator",
           "JournalRecord", "SequenceJournal", "SequenceManifest",
           "prompt_fingerprint", "TraceRecorder", "TraceReplayer",
           "load_trace", "save_trace", "synthesize_trace", "SwapError",
           "WeightSwapper"]
