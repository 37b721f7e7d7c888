"""Optimizers and learning-rate schedulers (counterpart of
``paddle_tpu/optimizer``: ``Optimizer``, its eleven rules,
``ExponentialMovingAverage`` and ``lr``)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        ExponentialMovingAverage, Ftrl, Lamb, LarsMomentum,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
           "ExponentialMovingAverage"]
