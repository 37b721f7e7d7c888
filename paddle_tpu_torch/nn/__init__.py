"""Layers of the port (counterpart of ``paddle_tpu/nn``), and the beam
decoder ``BeamSearchDecoder``/``dynamic_decode`` (reference ``:29``)."""
from . import functional, initializer
from .beam_decode import BeamSearchDecoder, dynamic_decode
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .container import Sequential
from .layer_base import Layer, ParamAttr
from .layers_activation import CrossEntropyLoss, LeakyReLU, ReLU, Tanh
from .layers_common import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AvgPool1D,
                            AvgPool2D, BatchNorm1D, BatchNorm2D, Conv2D,
                            Dropout, Embedding, Flatten, LayerNorm, Linear,
                            MaxPool1D, MaxPool2D, Upsample)
from .transformer import (CAUSAL_MASK, MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ParamAttr", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "clip_grad_norm_", "Layer", "Sequential",
           "CrossEntropyLoss", "LeakyReLU", "ReLU", "Tanh",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AvgPool1D", "AvgPool2D",
           "BatchNorm1D", "BatchNorm2D", "Conv2D", "Flatten", "MaxPool1D",
           "MaxPool2D", "Upsample", "Dropout", "Embedding", "LayerNorm",
           "Linear", "CAUSAL_MASK", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "BeamSearchDecoder", "dynamic_decode"]
