"""paddle.incubate (counterpart of ``paddle_tpu/incubate/__init__.py``):
the ``optimizer`` wrappers ``LookAhead`` and ``ModelAverage``. The rest of
the reference's incubate (checkpointing, segment ops, ``LayerHelper``)
is not ported yet (ROADMAP A8, A2)."""
from . import optimizer  # noqa: F401

__all__ = ["optimizer"]
