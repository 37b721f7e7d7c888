"""Functional ops the port's layers are built from (counterpart of
``paddle_tpu/nn/functional``)."""
from .activation import gelu, softmax
from .common import dropout, embedding, linear
from .norm import layer_norm

__all__ = ["gelu", "softmax", "dropout", "embedding", "linear",
           "layer_norm"]
