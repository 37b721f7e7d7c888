"""Layers of the port (counterpart of ``paddle_tpu/nn``, reference
``:2-39``): ``Layer``, the containers, the common, activation and loss
layers (``nn.loss`` names the latter module, as ``paddle.nn.loss``
does), the transformer, the beam decoder, the clips, ``nn.utils`` and
the weight and spectral norms, and the recurrent layers (``nn.RNN``,
``LSTM``, ``GRU``, ``SimpleRNN``, ``BiRNN`` and their cells, ``nn/rnn.py``).
``FLASH_CROSSOVER`` is a TPU constant the port does not carry."""
from . import functional, initializer
from . import layers_activation as loss
from . import utils
from .beam_decode import BeamSearchDecoder, dynamic_decode
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue, clip_grad_norm_)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layer_base import HookRemoveHelper, Layer, ParamAttr
from .layers_activation import *  # noqa: F401,F403
from .layers_activation import __all__ as _activation_all
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .layers_common import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                            AlphaDropout, AvgPool1D, AvgPool2D, AvgPool3D,
                            BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                            Bilinear, Conv1D, Conv1DTranspose, Conv2D,
                            Conv2DTranspose, Conv3D, Conv3DTranspose,
                            CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                            Embedding, Flatten, GroupNorm, InstanceNorm1D,
                            InstanceNorm2D, InstanceNorm3D, LayerNorm,
                            Linear, LocalResponseNorm, MaxPool1D, MaxPool2D,
                            MaxPool3D, Pad1D, Pad2D, Pad3D, PixelShuffle,
                            SpectralNorm, SyncBatchNorm, Unfold, Upsample,
                            UpsamplingBilinear2D, UpsamplingNearest2D,
                            ZeroPad2D)
from .transformer import (CAUSAL_MASK, MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)
from .utils_weight_norm import (remove_weight_norm, spectral_norm,
                                spectral_norm_fn, weight_norm)

_COMMON = [
    "Linear", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
    "Conv2DTranspose", "Conv3DTranspose", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "LayerNorm", "GroupNorm",
    "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm", "SpectralNorm", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D",
    "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "Embedding", "Dropout",
    "Dropout2D", "Dropout3D", "AlphaDropout", "Flatten", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "PixelShuffle", "Pad1D",
    "Pad2D", "Pad3D", "ZeroPad2D", "CosineSimilarity", "Bilinear", "Unfold"]

__all__ = ["functional", "initializer", "loss", "utils", "Layer",
           "ParamAttr", "HookRemoveHelper", "Sequential", "LayerList",
           "LayerDict", "ParameterList", *_COMMON, *_activation_all,
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "clip_grad_norm_", "CAUSAL_MASK",
           "MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer", "BeamSearchDecoder", "dynamic_decode",
           "weight_norm", "remove_weight_norm", "spectral_norm",
           "spectral_norm_fn", "RNNCellBase", "SimpleRNNCell", "LSTMCell",
           "GRUCell", "RNN", "SimpleRNN", "LSTM", "GRU", "BiRNN"]
