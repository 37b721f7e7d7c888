"""Device resolution and stat registries."""
from .device import resolve_device
from .monitor import StatRegistry

__all__ = ["resolve_device", "StatRegistry"]
