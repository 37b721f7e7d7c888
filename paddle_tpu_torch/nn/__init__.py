"""Layers of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .container import Sequential
from .layers_activation import CrossEntropyLoss, LeakyReLU, ReLU, Tanh
from .layers_common import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AvgPool1D,
                            AvgPool2D, BatchNorm1D, BatchNorm2D, Conv2D,
                            Dropout, Embedding, Flatten, LayerNorm, Linear,
                            MaxPool1D, MaxPool2D, Upsample)
from .transformer import (CAUSAL_MASK, MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "clip_grad_norm_", "Sequential",
           "CrossEntropyLoss", "LeakyReLU", "ReLU", "Tanh",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AvgPool1D", "AvgPool2D",
           "BatchNorm1D", "BatchNorm2D", "Conv2D", "Flatten", "MaxPool1D",
           "MaxPool2D", "Upsample", "Dropout", "Embedding", "LayerNorm",
           "Linear", "CAUSAL_MASK", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
