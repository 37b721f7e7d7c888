"""Functional ops the port's layers are built from (counterpart of
``paddle_tpu/nn/functional``)."""
from .activation import gelu, leaky_relu, relu, softmax, tanh
from .common import dropout, embedding, interpolate, linear, upsample
from .conv import conv2d
from .loss import cross_entropy, nll_loss, softmax_with_cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d, avg_pool1d,
                      avg_pool2d, max_pool1d, max_pool2d)

__all__ = ["gelu", "leaky_relu", "relu", "softmax", "tanh", "dropout",
           "embedding", "interpolate", "linear", "upsample", "conv2d",
           "cross_entropy", "nll_loss", "softmax_with_cross_entropy",
           "batch_norm", "layer_norm", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "avg_pool1d", "avg_pool2d", "max_pool1d",
           "max_pool2d"]
