"""Layers of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .layers_common import Dropout, Embedding, LayerNorm, Linear
from .transformer import (CAUSAL_MASK, MultiHeadAttention,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "clip_grad_norm_",
           "Dropout", "Embedding", "LayerNorm", "Linear", "CAUSAL_MASK",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
