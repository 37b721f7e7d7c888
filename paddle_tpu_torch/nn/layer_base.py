"""The module boundary of the port (counterpart of
``paddle_tpu/nn/layer_base.py``: ``Layer``, ``ParamAttr`` and
``HookRemoveHelper``).

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

The reference's own API sits beside torch's where their names meet
(reference ``:63-338``): ``full_name``, the forward pre- and post-hooks
(run in ``__call__`` around the unwrapping, in registration order, so a
hook sees the caller's types: Tensors when Tensors came in; a pre-hook's
non-None return replaces the positional inputs, a post-hook's the
outputs), ``parameters``/``buffers`` (lists, ``include_sublayers=``),
``named_parameters``/``named_buffers``, ``sublayers``/
``named_sublayers``, ``add_sublayer``, ``add_parameter``,
``register_buffer(name, tensor, persistable=)``, ``create_tensor``,
``state_dict(include_sublayers=, structured_name_prefix=)``,
``set_state_dict``/``load_dict`` (shape-checked, copied in place, so a
captured program that bound the old storage reads the new values),
``to(device, dtype, blocking)``, ``astype``, ``apply`` (the layer first,
then its sublayers), ``clear_gradients`` and the reference's
``__repr__``. torch's own keywords (``recurse=``, ``remove_duplicate=``,
``prefix=``, ``keep_vars=``, ``destination=``, ``persistent=``) still
work where torch's code passes them (``Module.state_dict`` recursing,
``load_state_dict``, ``copy.deepcopy``, ``torch.utils.checkpoint``).
``state_dict`` keeps torch's keys and order (each layer's parameters,
then its persistent buffers, in registration order), which
``framework_io`` and ``paddle.save`` have always written.

:class:`ParamAttr` (reference ``:34``) names a parameter's initializer,
learning-rate scale, regularizer, trainability and clipping;
:meth:`Layer.create_parameter` (reference ``:82``) makes a
:class:`~paddle_tpu_torch.core.tensor.Parameter` from it on the device
entry points run on, setting ``optimize_attr``,
``regularizer`` and ``need_clip``, which the optimizers and the clips
read.
"""
from __future__ import annotations

import collections
import weakref

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import dtypes as _dt
from ..core.device import resolve_device
from ..core.tensor import Parameter, Tensor
from . import initializer as I

__all__ = ["Layer", "ParamAttr", "HookRemoveHelper"]


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


def _is_dtensor(t) -> bool:
    if type(t) is torch.Tensor or not isinstance(t, torch.Tensor):
        return False
    from ..distributed.mesh import is_dtensor
    return is_dtensor(t)


class HookRemoveHelper:
    """The handle a hook registration returns: ``remove()`` takes the
    hook out (reference ``:25``)."""

    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


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


def _as_torch(v):
    """A torch tensor of ``v`` (a Tensor, a torch tensor or an array)."""
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


#: every live Layer, deep copies included (``__new__`` runs for both), so
#: ``distributed.shard_tensor`` can swap a parameter where it is held
_LIVE_LAYERS: "weakref.WeakSet" = weakref.WeakSet()


def live_layers():
    return list(_LIVE_LAYERS)


class Layer(torch.nn.Module):
    """A ``torch.nn.Module`` that takes and returns paddle Tensors at its
    boundary, with the reference's ``Layer`` API (module docstring)."""

    _global_counter = collections.defaultdict(int)

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        _LIVE_LAYERS.add(obj)
        return obj

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        cls = type(self).__name__.lower()
        Layer._global_counter[cls] += 1
        self._full_name = name_scope or \
            f"{cls}_{Layer._global_counter[cls] - 1}"
        self._dtype = _dt.convert_dtype(dtype)
        self._pre_hooks = collections.OrderedDict()
        self._post_hooks = collections.OrderedDict()
        self._hook_id = 0

    # -- execution ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        pre = self.__dict__.get("_pre_hooks")
        post = self.__dict__.get("_post_hooks")
        if pre:
            for hook in list(pre.values()):
                out = hook(self, args)
                if out is not None:
                    args = out if isinstance(out, tuple) else (out,)
        out = self._call(args, kwargs)
        if post:
            for hook in list(post.values()):
                o = hook(self, args, out)
                if o is not None:
                    out = o
        return out

    def _call(self, args, kwargs):
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

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs)`` before each forward; a non-None return
        replaces ``inputs`` (a tuple, or one value)."""
        self._hook_id += 1
        self._pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)`` after each forward; a non-None
        return replaces ``outputs``."""
        self._hook_id += 1
        self._post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._post_hooks, self._hook_id)

    # -- parameters, buffers, sublayers ---------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A :class:`Parameter` made by :func:`make_parameter` on the
        device entry points run on, in the layer's dtype by default; not
        registered until it is assigned to an attribute, as in the
        reference."""
        return make_parameter(shape, attr, dtype or self.__dict__.get(
            "_dtype"), is_bias, default_initializer)

    def create_tensor(self, name=None, persistable=False, dtype=None):
        """A zero scalar Tensor of ``dtype`` (the layer's by default)."""
        return Tensor._wrap(torch.zeros(
            [], dtype=_dt.convert_dtype(dtype) or self._dtype,
            device=resolve_device()))

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (made a :class:`Parameter` if it is not
        one) as ``name``; None registers no data."""
        if parameter is not None and not isinstance(parameter, Parameter):
            parameter = Parameter(_as_torch(parameter).detach().clone())
        if name not in self._parameters:
            self.__dict__.pop(name, None)
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Register ``tensor`` as buffer ``name``, in the state dict
        unless ``persistable`` (torch's ``persistent``) is False; returns
        it."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None:
            tensor = _as_torch(tensor)
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def parameters(self, include_sublayers=True, *, recurse=None):
        """The parameters, each once, in registration order (a list)."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True, *, recurse=None,
                         remove_duplicate=True):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, *,
                      recurse=None, remove_duplicate=True):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """``(name, layer)`` of every sublayer, depth first in
        registration order, each once."""
        for name, m in self.named_modules(
                memo=layers_set if layers_set is not None else set(),
                prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def apply(self, fn):
        """``fn`` on the layer, then on each sublayer (the reference's
        order; torch's ``apply`` goes children first)."""
        for m in self.sublayers(include_self=True):
            fn(m)
        return self

    # -- state ----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """Parameters and persistable buffers by structured name, torch's
        order (module docstring); ``include_sublayers=False`` keeps the
        layer's own."""
        if prefix is not None:          # torch's recursion
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        if include_sublayers:
            dest = super().state_dict(destination=destination,
                                      prefix=structured_name_prefix,
                                      keep_vars=keep_vars)
        else:
            dest = collections.OrderedDict() if destination is None \
                else destination
            self._save_to_state_dict(dest, structured_name_prefix,
                                     keep_vars)
        if not keep_vars:
            # a sharded parameter's value is its global one, gathered, as
            # the JAX package's state_dict holds global arrays
            for k, v in dest.items():
                if _is_dtensor(v):
                    from ..distributed.mesh import full
                    dest[k] = full(v)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (Tensors, torch tensors or
        arrays) into the layer's parameters and buffers in place, each
        cast to its target's dtype; a shape that differs raises
        ``ValueError``. Returns ``(missing, unexpected)`` keys."""
        own = self.state_dict(keep_vars=True)
        missing = []
        for k, t in own.items():
            if k not in state_dict:
                missing.append(k)
                continue
            v = _as_torch(state_dict[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(v.shape)} vs {tuple(t.shape)}")
            v = v.to(device=t.device, dtype=t.dtype)
            if _is_dtensor(t):
                # each rank keeps its slice of the global value
                from ..distributed.mesh import like
                v = like(v, t)
            t.copy_(v)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    # -- casting --------------------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` with paddle's
        spellings (``"gpu"``, ``"float16"``), or torch's own arguments;
        floating parameters and buffers only change type, as in both."""
        rest = []
        for a in args:
            if isinstance(a, str):
                try:
                    dtype = _dt.convert_dtype(a)
                    continue
                except TypeError:
                    a = resolve_device(a)
            elif isinstance(a, torch.dtype):
                dtype = a
                continue
            rest.append(a)
        if isinstance(device, str):
            device = resolve_device(device)
        if device is not None:
            kwargs["device"] = device
        if dtype is not None:
            kwargs["dtype"] = _dt.convert_dtype(dtype)
            for m in self.modules():
                if "_dtype" in m.__dict__:
                    m._dtype = kwargs["dtype"]
        return super().to(*rest, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return self._full_name

    def __repr__(self):
        extra = self.extra_repr()
        lines = [f"{type(self).__name__}({extra}" if extra
                 else f"{type(self).__name__}("]
        for name, sub in self._modules.items():
            if sub is None:
                continue
            lines.append(f"  ({name}): "
                         + "\n  ".join(repr(sub).split("\n")))
        lines.append(")")
        return "\n".join(lines) if len(lines) > 2 else \
            f"{type(self).__name__}({extra})"
