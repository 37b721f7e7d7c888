"""The high-level training API (counterpart of ``paddle_tpu/hapi``)."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
