"""The heartbeat plane's environment contract (counterpart of the part of
``paddle_tpu/distributed/elastic_runtime/heartbeat.py`` that the watchdog
reads): the cohort generation a supervisor stamps into every child, and
:func:`maybe_auto_sender`, which would start the beacon sender when the
supervisor names a coordinator. The sender, the coordinator and the
straggler detector are ROADMAP A10's second slice: with
``PADDLE_TPU_HEARTBEAT_ADDR``
set, :func:`maybe_auto_sender` raises naming it."""
from __future__ import annotations

import os

#: env var the cohort supervisor sets in every child: "host:port" of the
#: heartbeat coordinator; its presence asks for a beacon sender.
HEARTBEAT_ADDR_VAR = "PADDLE_TPU_HEARTBEAT_ADDR"

#: env var carrying the cohort generation (bumped by the supervisor on
#: every re-formation; generation 0 is the initial world).
COHORT_GEN_VAR = "PADDLE_TPU_COHORT_GEN"


def cohort_generation() -> int:
    """This process's cohort generation (0 outside a cohort supervisor)."""
    try:
        return int(os.environ.get(COHORT_GEN_VAR, "0"))
    except ValueError:
        return 0


def maybe_auto_sender():
    """None outside a cohort supervisor; with
    :data:`HEARTBEAT_ADDR_VAR` set, the beacon sender it asks for is
    ROADMAP A10's second slice and this raises."""
    addr = os.environ.get(HEARTBEAT_ADDR_VAR, "")
    if not addr:
        return None
    raise NotImplementedError(
        f"{HEARTBEAT_ADDR_VAR}={addr}: the heartbeat beacon sender (and its "
        "coordinator) are ROADMAP A10's second slice; the port runs the "
        "step watchdog "
        "without one")
