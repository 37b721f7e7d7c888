"""Optimizers and learning-rate schedulers (counterpart of
``paddle_tpu/optimizer``: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``,
``AdamW`` and ``lr``)."""
from . import lr
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
