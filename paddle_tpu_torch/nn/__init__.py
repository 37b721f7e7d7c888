"""Layers of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .container import Sequential
from .layers_activation import LeakyReLU
from .layers_common import (BatchNorm1D, BatchNorm2D, Conv2D, Dropout, Embedding,
                            LayerNorm, Linear, Upsample)
from .transformer import (CAUSAL_MASK, MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "clip_grad_norm_",
           "Sequential", "LeakyReLU", "BatchNorm1D", "BatchNorm2D", "Conv2D", "Upsample",
           "Dropout", "Embedding", "LayerNorm", "Linear", "CAUSAL_MASK",
           "MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
