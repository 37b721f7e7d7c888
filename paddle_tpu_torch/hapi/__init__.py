"""The high-level training API (counterpart of ``paddle_tpu/hapi``)."""
from . import callbacks
from .model import Model, summary

__all__ = ["Model", "summary", "callbacks"]
