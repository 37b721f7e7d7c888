"""The module boundary of the port (counterpart of
``paddle_tpu/nn/layer_base.py``: ``Layer`` and ``ParamAttr``).

:class:`Layer` is a ``torch.nn.Module``. Its ``__call__`` is where
paddle's Tensors meet torch modules: when a Tensor comes in (as an
argument, a keyword, or an item of a list or tuple argument), it is
unwrapped, ``forward`` runs on torch tensors, and the torch tensors it
returns (at any pytree position) are wrapped back into Tensors, autograd
graph and all; with no Tensor in, the call is torch's own, so a layer's
internals and every path that hands it torch tensors (``Model``, the
engines, the captured programs) keep torch types and pay nothing more
(a Tensor a forward made itself, through ``paddle.arange`` say, is
unwrapped on the way out).
Every layer of the port derives from it.

:class:`ParamAttr` (reference ``:34``) names a parameter's initializer,
learning-rate scale, regularizer, trainability and clipping;
:meth:`Layer.create_parameter` (reference ``:82``) makes a
:class:`~paddle_tpu_torch.core.tensor.Parameter` from it on the device
entry points run on, setting ``optimize_attr``,
``regularizer`` and ``need_clip``, which the optimizers and the clips
read. The rest of the reference's ``Layer`` API (``sublayers``, forward
hooks, ``parameters(include_sublayers=)``) is ROADMAP.md queue A3.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..core import dtypes as _dt
from ..core.device import resolve_device
from ..core.tensor import Parameter, Tensor
from . import initializer as I

__all__ = ["Layer", "ParamAttr"]


def _has_tensor(args) -> bool:
    """Whether ``args`` holds a Tensor, in its lists and tuples too (a
    list of ``Cache`` namedtuples of Tensors)."""
    for a in args:
        if isinstance(a, Tensor):
            return True
        if isinstance(a, (list, tuple)) and _has_tensor(a):
            return True
    return False


def _holds_tensor(out) -> bool:
    """Whether ``out`` holds a Tensor in its lists, tuples and dicts,
    without a pytree walk: torch tensors (a block's output, a cache's
    buffers) are passed over in one type check each."""
    if isinstance(out, Tensor):
        return True
    if isinstance(out, dict):
        out = tuple(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            if not isinstance(x, torch.Tensor) and _holds_tensor(x):
                return True
    return False


def _unwrap(a):
    if isinstance(a, Tensor):
        return a._data
    if isinstance(a, (list, tuple)) and _has_tensor(a):
        items = [_unwrap(x) for x in a]
        if isinstance(a, list):
            return items
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


class ParamAttr:
    """A parameter's attributes (reference: fluid/param_attr.py
    ParamAttr): ``name``, ``initializer``, ``learning_rate`` (a scale of
    the optimizer's), ``regularizer``, ``trainable``,
    ``do_model_average`` and ``need_clip``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """A ParamAttr for ``attr``: None gives the defaults, a string the
        name, an initializer the initializer; ``False`` stays ``False``
        (no parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        return ParamAttr()


def make_parameter(shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None, device=None):
    """A :class:`Parameter` of ``shape`` made as ``attr`` says (a
    ``ParamAttr``, an initializer, a name, None or ``False``, which gives
    None): its initializer, else ``default_initializer``, else zeros for
    a bias and Xavier-uniform for a weight (reference: layers.py
    create_parameter)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    init = attr.initializer or default_initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    data = init([int(s) for s in shape],
                _dt.convert_dtype(dtype) or torch.float32,
                resolve_device(device))
    p = Parameter(data, trainable=attr.trainable,
                  regularizer=attr.regularizer, need_clip=attr.need_clip,
                  do_model_average=attr.do_model_average)
    p.optimize_attr["learning_rate"] = attr.learning_rate
    if attr.name is not None:
        p.name = attr.name
    return p


class Layer(torch.nn.Module):
    """A ``torch.nn.Module`` that takes and returns paddle Tensors at its
    boundary (module docstring)."""

    def __call__(self, *args, **kwargs):
        if not (_has_tensor(args) or (kwargs
                                      and _has_tensor(kwargs.values()))):
            out = super().__call__(*args, **kwargs)
            if isinstance(out, Tensor):
                return out._data
            if not _holds_tensor(out):
                return out
            # a forward that made Tensors of its own (paddle.arange...)
            # still hands torch tensors back to a torch caller
            return pytree.tree_map_only(Tensor, _unwrap, out)
        out = super().__call__(*[_unwrap(a) for a in args],
                               **{k: _unwrap(v) for k, v in kwargs.items()})
        if isinstance(out, torch.Tensor):
            return Tensor._wrap(out)
        return pytree.tree_map_only(torch.Tensor, Tensor._wrap, out)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A :class:`Parameter` made by :func:`make_parameter` on the
        device entry points run on; not registered until it is assigned
        to an attribute, as in the reference."""
        return make_parameter(shape, attr, dtype, is_bias,
                              default_initializer)
