"""Layers of the port (counterpart of ``paddle_tpu/nn``)."""
from . import functional
from .layers_common import Dropout, Embedding, LayerNorm, Linear
from .transformer import (CAUSAL_MASK, MultiHeadAttention,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear",
           "CAUSAL_MASK", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
