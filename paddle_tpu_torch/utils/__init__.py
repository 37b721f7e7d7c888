"""Host-side utilities (counterpart of ``paddle_tpu/utils``): retry,
deadlines and fault injection (:mod:`.resilience`), and ``Profiler``,
re-exported as the reference's ``utils/__init__.py:114`` does."""
from ..profiler import Profiler  # noqa: F401
