"""Activation, loss and distance layers (counterpart of
``paddle_tpu/nn/layers_activation.py``, which ``nn.loss`` also names, as
the reference's ``paddle.nn.loss`` does).

Each is a thin layer over the port's functional op of the same name with
its arguments fixed at construction, as in the reference, so
``Hardsigmoid`` has the reference's slope 0.1666667 (its
``F.hardsigmoid``), not torch's 1/6. ``PReLU`` owns its slopes
(``Constant(init)`` by default), ``RReLU`` draws its slopes through
:func:`~paddle_tpu_torch.core.generator.draw` while training, and
``HSigmoidLoss`` owns the tree's ``weight`` ``[C - 1, feature_size]``
(Xavier-uniform) and ``bias`` ``[C - 1, 1]`` (zeros); their parameters
are drawn at construction and again by ``reset_parameters``
(``nn/layers_common.py``).
"""
from __future__ import annotations

import torch

from ..core.device import DeviceLike, resolve_device
from ..ops.math import norm as _p_norm
from . import functional as F
from . import initializer as I
from .layer_base import Layer
from .layers_common import _param, _reset

__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "ELU", "SELU", "CELU", "Silu", "Swish", "Mish",
    "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
    "Tanhshrink", "Softplus", "Softsign", "LogSigmoid", "ThresholdedReLU",
    "Maxout", "PReLU", "RReLU", "GLU", "CrossEntropyLoss", "MSELoss",
    "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
    "SmoothL1Loss", "MarginRankingLoss", "CTCLoss", "CosineEmbeddingLoss",
    "TripletMarginLoss", "HSigmoidLoss", "PairwiseDistance"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)

    def extra_repr(self):
        return f"approximate={self._approximate}"


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)

    def extra_repr(self):
        return f"axis={self._axis}"


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)

    def extra_repr(self):
        return f"axis={self._axis}"


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)

    def extra_repr(self):
        return f"negative_slope={self._negative_slope}"


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)

    def extra_repr(self):
        return f"alpha={self._alpha}"


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)

    def extra_repr(self):
        return f"scale={self._scale}" + ", " + f"alpha={self._alpha}"


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)

    def extra_repr(self):
        return f"alpha={self._alpha}"


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    pass


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)

    def extra_repr(self):
        return f"min={self._min}" + ", " + f"max={self._max}"


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)

    def extra_repr(self):
        return f"threshold={self._threshold}"


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)

    def extra_repr(self):
        return f"threshold={self._threshold}"


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)

    def extra_repr(self):
        return f"beta={self._beta}" + ", " + f"threshold={self._threshold}"


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)

    def extra_repr(self):
        return f"threshold={self._threshold}"


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)

    def extra_repr(self):
        return f"groups={self._groups}" + ", " + f"axis={self._axis}"


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)

    def extra_repr(self):
        return f"axis={self._axis}"


class PReLU(Layer):
    """``max(0, x) + weight * min(0, x)`` with ``num_parameters`` slopes
    (one, or one a channel), ``Constant(init)`` by default."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self._data_format = data_format
        _param(self, "weight", [num_parameters], weight_attr,
               resolve_device(device), dtype, I.Constant(init))

    reset_parameters = _reset

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)

    def extra_repr(self):
        return f"lower={self._lower}, upper={self._upper}"


# -- loss layers ------------------------------------------------------------

class CrossEntropyLoss(Layer):
    """:func:`~paddle_tpu_torch.nn.functional.cross_entropy` with the
    keywords fixed at construction (``:254``)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction, soft_label=soft_label,
                        axis=axis, use_softmax=use_softmax)

    def forward(self, input, label):
        return F.cross_entropy(input, label, **self._kw)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, ignore_index=ignore_index,
                        reduction=reduction)

    def forward(self, input, label):
        return F.nll_loss(input, label, **self._kw)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight, self._reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, reduction=reduction,
                        pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self._kw)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction, self._delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                        reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, **self._kw)


class HSigmoidLoss(Layer):
    """:func:`~paddle_tpu_torch.nn.functional.hsigmoid_loss` over the
    tree's ``weight`` and ``bias``, which the layer owns
    (``bias_attr=False`` for none)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.is_sparse = is_sparse
        dev = resolve_device(device)
        _param(self, "weight", [num_classes - 1, feature_size], weight_attr,
               dev, dtype, I.XavierUniform())
        _param(self, "bias", [num_classes - 1, 1], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise ValueError("is_custom=True needs path_table/path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code,
                               self.is_sparse)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return _p_norm(x - y + self.epsilon, p=self.p, axis=-1,
                       keepdim=self.keepdim)
