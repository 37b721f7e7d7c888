"""Functional ops (counterpart of ``paddle_tpu/nn/functional``): the
activations, common ops, norms and losses in full, the convolutions
(``conv1d/2d/3d``, their transposes, ``deformable_conv``), the pools
(max, average, adaptive average and adaptive max, 1-D to 3-D),
``flash_attention`` (whose wrapper
launches the B1-B3 kernels on the card), ``pixel_shuffle``/
``pixel_unshuffle``, the in-place ``tanh_``, ``elu_`` and ``softmax_``,
the sampled heads of ``sampled`` and ``ops.beam``'s ``gather_tree``
(reference ``:25-32``)."""
from ...ops.beam import gather_tree
from ...ops.flash_attention import flash_attention
from ...ops.manipulation import cast as _cast
from ...ops.manipulation import pixel_shuffle, pixel_unshuffle
from ...ops.math import tanh as _tanh
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .activation import elu, softmax
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv_all
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cosine_similarity, cross_entropy,
                   ctc_greedy_decoder, ctc_loss, dice_loss,
                   hinge_embedding_loss, hinge_loss, huber_loss, kl_div,
                   l1_loss, label_smooth, log_loss, margin_ranking_loss,
                   mse_loss, nll_loss, rank_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss, warpctc)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize)
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling_all
from .sampled import (class_center_sample, hierarchical_sigmoid,
                      hsigmoid_loss, nce, sample_logits, sampling_id)


def _inplace(fn, x, *a, **k):
    x._swap_payload(fn(x, *a, **k))     # recorded by autograd
    return x


def tanh_(x, name=None):
    return _inplace(_tanh, x)


def elu_(x, alpha=1.0, name=None):
    return _inplace(elu, x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    out = softmax(x, axis)
    if dtype is not None:
        out = _cast(out, dtype)
    x._swap_payload(out)
    return x


__all__ = sorted(set(_activation_all) | set(_common_all) | set(_conv_all)
                 | set(_pooling_all) | {
    "flash_attention", "pixel_shuffle", "pixel_unshuffle",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "cosine_embedding_loss", "cosine_similarity", "cross_entropy",
    "ctc_greedy_decoder", "ctc_loss", "dice_loss", "hinge_embedding_loss",
    "hinge_loss", "huber_loss", "kl_div", "l1_loss", "label_smooth",
    "log_loss", "margin_ranking_loss", "mse_loss", "nll_loss", "rank_loss",
    "sigmoid_focal_loss", "smooth_l1_loss", "softmax_with_cross_entropy",
    "square_error_cost", "triplet_margin_loss", "warpctc", "batch_norm",
    "group_norm", "instance_norm", "layer_norm", "local_response_norm",
    "normalize", "tanh_", "elu_",
    "softmax_", "gather_tree", "class_center_sample",
    "hierarchical_sigmoid", "hsigmoid_loss", "nce", "sample_logits",
    "sampling_id"})
