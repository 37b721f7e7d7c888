"""The elastic runtime's in-process half (counterpart of
``paddle_tpu/distributed/elastic_runtime/__init__.py``): the collective
watchdog (:mod:`.watchdog`, ``StepWatchdog``, which converts a hung step
into exit :data:`~paddle_tpu_torch.distributed.elastic.HOST_LOST_EXIT_CODE`,
121) and, of the heartbeat plane (:mod:`.heartbeat`), the cohort
generation and the auto-armed beacon sender's entry point. The beacon
sender and coordinator and the cohort supervisor are the second slice of
ROADMAP A10 (the launcher's ``--elastic`` supervisor is
``distributed/launch.py``)."""
from ..elastic import HOST_LOST_EXIT_CODE  # noqa: F401
from .heartbeat import (  # noqa: F401
    COHORT_GEN_VAR, HEARTBEAT_ADDR_VAR, cohort_generation, maybe_auto_sender,
)
from .watchdog import (  # noqa: F401
    STEP_DEADLINE_VAR, StepWatchdog, maybe_auto_watchdog,
)

__all__ = ["HOST_LOST_EXIT_CODE", "COHORT_GEN_VAR", "HEARTBEAT_ADDR_VAR",
           "cohort_generation", "maybe_auto_sender", "STEP_DEADLINE_VAR",
           "StepWatchdog", "maybe_auto_watchdog"]
