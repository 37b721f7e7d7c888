"""The eager Tensor and the Parameter (counterpart of
``paddle_tpu/core/tensor.py``).

A :class:`Tensor` holds one ``torch.Tensor`` (``_data``), as the JAX
package's holds one ``jax.Array``; it does not subclass ``torch.Tensor``,
because paddle's ``shape`` (a list), ``dtype``, ``transpose(perm)``,
``reshape``, ``sum(axis=)``, ``numpy()`` and ``to()`` mean other things
than torch's methods of the same names, which the port's modules and
torch's own library code call with torch's meaning. Gradients come from
torch autograd (``core/autograd_engine.py``), not a tape:

- ``stop_gradient`` defaults to True for data. A floating Tensor with
  ``stop_gradient=False`` has ``_data.requires_grad``; an integer one
  keeps the flag and is never differentiated, as in the JAX package.
- ``backward()`` runs ``torch.autograd.backward`` on ``_data``; ``.grad``
  wraps the gradient torch accumulated, ``clear_grad()`` drops it.
- ``set_value`` and ``copy_`` replace ``_data`` by a new tensor and bump
  ``_inplace_version``. Where the old value was a leaf that needs a
  gradient, a hook on it raises ``RuntimeError`` if a backward still
  reaches it: the JAX package's in-place guard
  (``autograd_engine.py:279``). The gradient accumulated so far moves
  to the new value.
- ``__setitem__`` is out of place and recorded by autograd: the write
  goes into a clone, which becomes ``_data`` (torch refuses in-place
  writes to a leaf that requires grad). After a write to a leaf, the
  gradient still accumulates on that leaf and ``.grad`` reads it, as the
  JAX package's ``_swap_payload`` does.
- ``register_hook`` hands the hook Tensors and takes a Tensor back.

Every op a Tensor method runs goes through the dispatch funnel
(``ops/dispatch.py``); the math methods and operator dunders are attached
by ``ops/__init__.py``, as the JAX package attaches its table.

:class:`Parameter` is a ``torch.nn.Parameter`` (so layers, optimizers
and CUDA graphs take it as they take any parameter) carrying paddle's
attributes: ``stop_gradient`` (the inverse of ``requires_grad``),
``trainable``, ``optimize_attr``, ``regularizer``, ``need_clip``,
``do_model_average``, ``clear_grad()`` and ``set_value``, which copies
in place under ``no_grad``, since captured programs bind a parameter's
address. Names torch already defines keep torch's meaning
(``shape``, ``grad``); ``numpy()`` detaches first.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from . import dtypes as _dtypes
from .device import Place, resolve_device

__all__ = ["Tensor", "Parameter", "stable_uid"]


def _from_host(data, dtype, place) -> torch.Tensor:
    """A new torch tensor on ``place`` from host data. float64 data
    without a dtype takes the default dtype (the JAX package's
    convention); integer data keeps its width (int64 for Python ints)."""
    arr = np.asarray(data)
    if arr.dtype.name == "bfloat16":           # ml_dtypes, where present
        arr = arr.astype(np.float32)
        dtype = dtype or _dtypes.bfloat16
    if dtype is None and arr.dtype == np.float64:
        dtype = _dtypes.get_default_dtype()
    return torch.tensor(arr, dtype=dtype, device=resolve_device(place))


def _raise_modified(grad):
    raise RuntimeError(
        "a Tensor needed for backward was modified in place by set_value "
        "after it was used (TensorInplaceVersion guard); this would "
        "produce wrong gradients")


class Tensor:
    """paddle's eager Tensor over one ``torch.Tensor`` (see the module
    docstring)."""

    # defaults an instance overrides only when it differs
    name = None
    persistable = False
    is_distributed = False
    _inplace_version = 0
    #: the torch leaf this Tensor's gradient accumulates on when it is
    #: not ``_data`` (after ``__setitem__`` on a leaf)
    _grad_holder = None
    #: user hooks by id: (hook, torch handle on the current ``_data``)
    _hooks = None
    _hook_counter = 0

    def __init__(self, data, dtype=None, place=None, stop_gradient=True,
                 name=None, persistable=False):
        if isinstance(data, Tensor):
            data = data._data
        d = _dtypes.convert_dtype(dtype)
        if isinstance(data, torch.Tensor):
            t = data
            if place is not None:
                t = t.to(resolve_device(place))
            if d is not None and t.dtype != d:
                t = t.to(d)
            if t.requires_grad and stop_gradient:
                t = t.detach()
        else:
            t = _from_host(data, d, place)
        self._data = t
        self._stop_gradient = True
        self.stop_gradient = stop_gradient
        if name is not None:
            self.name = name
        if persistable:
            self.persistable = persistable

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        """A Tensor over an op's output, its ``stop_gradient`` from
        whether autograd recorded it (the funnel's wrap)."""
        out = object.__new__(cls)
        out._data = t
        out._stop_gradient = not t.requires_grad
        return out

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self) -> Place:
        return Place.of(self._data.device)

    @property
    def is_leaf(self):
        return self._data.is_leaf

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        self._stop_gradient = value
        t = self._data
        if not (t.is_floating_point() or t.is_complex()):
            return      # kept as a flag, never differentiated
        if t.is_leaf:
            if t.requires_grad == value:
                t.requires_grad_(not value)
        elif value:
            self._data = t.detach()

    @property
    def trainable(self):
        return not self._stop_gradient

    @trainable.setter
    def trainable(self, value):
        self.stop_gradient = not value

    def _holder(self) -> torch.Tensor:
        h = self._grad_holder
        return self._data if h is None else h

    @property
    def grad(self):
        h = self._holder()
        if not h.is_leaf or h.grad is None:
            return None
        return Tensor._wrap(h.grad)

    @grad.setter
    def grad(self, value):
        self._holder().grad = None if value is None else _raw(value)

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        _ag.backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self):
        self._holder().grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """Call ``hook(grad)`` with the gradient as a Tensor when it is
        computed; a Tensor it returns replaces the gradient. Returns a
        handle with ``remove()``."""
        if self._hooks is None:
            self._hooks = {}
        hid = self._hook_counter
        self._hook_counter = hid + 1
        self._hooks[hid] = [hook, self._attach_hook(hook)]
        tensor = self

        class _Handle:
            def remove(self):
                entry = tensor._hooks.pop(hid, None)
                if entry is not None and entry[1] is not None:
                    entry[1].remove()
        return _Handle()

    def _attach_hook(self, hook):
        if not self._data.requires_grad:
            return None         # never fires, as for a stop_gradient Tensor

        def run(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else _raw(out)
        return self._data.register_hook(run)

    def _swap(self, new: torch.Tensor):
        """Make ``new`` the payload, keeping the Tensor's flag and
        re-attaching its hooks."""
        if self._stop_gradient and new.requires_grad:
            new = new.detach()
        self._data = new
        if self._hooks:
            for entry in self._hooks.values():
                entry[1] = self._attach_hook(entry[0])

    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._data.detach())
        if self.name is not None:
            t.name = self.name
        return t

    def requires_grad_(self, value: bool = True):
        self.stop_gradient = not value
        return self

    # -- conversion ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A host copy; bfloat16 comes back as float32 (NumPy has no
        bfloat16 without ml_dtypes)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype) -> "Tensor":
        return _dispatch.apply("cast", _cast, self,
                               dtype=_dtypes.convert_dtype(dtype))

    cast = astype

    def clone(self) -> "Tensor":
        return _dispatch.apply("clone", torch.clone, self)

    def cpu(self):
        return Tensor(self._data.detach().cpu(),
                      stop_gradient=self._stop_gradient)

    def pin_memory(self):
        return self      # the JAX package's: staging is the loader's job

    _DEVICE_PREFIXES = ("cpu", "gpu", "cuda", "xpu", "npu", "tpu", "ipu")

    def to(self, *args, **kwargs):
        """``to(dtype)``, ``to(device)`` or ``to(device, dtype)``: dtypes
        cast, devices move (both recorded by autograd); a string that is
        neither a dtype nor a device raises."""
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, str):
                try:
                    dtype = _dtypes.convert_dtype(a)
                    continue
                except TypeError:
                    pass
                if a.split(":")[0] not in Tensor._DEVICE_PREFIXES:
                    raise ValueError(
                        f"Tensor.to: {a!r} is neither a known dtype nor a "
                        f"device (cpu/gpu[:N])")
                device = a
            elif isinstance(a, (Place, torch.device)):
                device = a
            else:
                dtype = a
        out = self
        if device is not None:
            dev = resolve_device(device)
            if dev != self._data.device:
                out = _dispatch.apply("memcpy", _move, self, device=dev)
        if dtype is not None:
            out = out.astype(dtype)
        return out

    def value(self):
        return self

    def get_tensor(self):
        return self

    # -- mutation (in-place style) -----------------------------------------
    def set_value(self, value):
        """Replace the contents (reference: VarBase SetValue), same shape,
        cast to this Tensor's dtype; bumps ``_inplace_version``."""
        raw = _raw(value)
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(np.asarray(value))
        old = self._data
        if tuple(raw.shape) != tuple(old.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(raw.shape)} "
                             f"vs {tuple(old.shape)}")
        new = raw.detach().to(device=old.device, dtype=old.dtype, copy=True)
        holder = self._holder()
        if holder.is_leaf and holder.requires_grad:
            if holder.grad is not None:
                new.grad = holder.grad
            holder.register_hook(_raise_modified)
        if not self._stop_gradient and (new.is_floating_point()
                                        or new.is_complex()):
            new.requires_grad_(True)
        self._grad_holder = None
        self._inplace_version += 1
        self._swap(new)

    def copy_(self, other, blocking=True):
        self.set_value(other)
        return self

    def _swap_payload(self, other: "Tensor"):
        """Adopt another Tensor's payload, keeping the gradient on this
        Tensor's leaf (the in-place methods: ``add_``, ``scale_``...).
        Recorded by autograd, so it does not bump ``_inplace_version``."""
        if self._grad_holder is None and self._data.is_leaf \
                and self._data.requires_grad:
            self._grad_holder = self._data
        self._swap(other._data)

    def __setitem__(self, idx, value):
        out = _dispatch.apply("set_value", _setitem, self, value,
                              idx=_unwrap_index(idx))
        self._swap_payload(out)

    def __getitem__(self, idx):
        return _dispatch.apply("getitem", _getitem, self,
                               idx=_unwrap_index(idx))

    # -- misc ---------------------------------------------------------------
    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_s = "" if self._stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, "
                f"dtype={_dtypes.dtype_name(self.dtype)}, place={self.place}"
                f"{grad_s},\n       {self.numpy()!r})")

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __index__(self):
        return int(self._data.item())

    def __format__(self, spec):
        if self._data.dim() == 0:
            return format(self._data.item(), spec)
        return repr(self)

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def block_until_ready(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _cast(x, dtype):
    return x.to(dtype)


def _move(x, device):
    return x.to(device)


def _getitem(x, idx):
    return x[idx]


def _setitem(x, v, idx):
    """``x`` with ``x[idx] = v`` written into a clone; ``v`` cast to
    ``x``'s dtype, leading size-1 axes dropped where the slot has fewer
    dims (paddle and NumPy assign shape (1,) to a scalar slot)."""
    out = x.clone()
    v = v.to(x.dtype) if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v, dtype=x.dtype, device=x.device)
    target = out[idx].dim()
    while v.dim() > target and v.shape[0] == 1:
        v = v.reshape(v.shape[1:])
    out[idx] = v
    return out


def _unwrap_index(idx):
    if isinstance(idx, tuple):
        return tuple(i._data if isinstance(i, Tensor) else i for i in idx)
    return idx._data if isinstance(idx, Tensor) else idx


class Parameter(torch.nn.Parameter):
    """A trainable parameter (reference: ParamBase): a
    ``torch.nn.Parameter`` with paddle's attributes (module docstring)."""

    def __new__(cls, data=None, requires_grad=True, *, trainable=None,
                regularizer=None, need_clip=True, do_model_average=None):
        if isinstance(data, Tensor):
            data = data._data
        if trainable is not None:
            requires_grad = bool(trainable)
        p = super().__new__(cls, data, requires_grad)
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = regularizer
        p.need_clip = need_clip
        p.do_model_average = do_model_average
        p.persistable = True
        p.is_distributed = False
        return p

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def name(self):
        """The name a ``ParamAttr`` gave (None by default); torch's own
        ``Tensor.name`` cannot be written."""
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def _inplace_version(self):
        return self._version

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    @torch.no_grad()
    def set_value(self, value):
        """Copy ``value`` in, in place (the address stays, so a captured
        program reads the new values)."""
        raw = _raw(value)
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(np.asarray(value))
        if tuple(raw.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(raw.shape)} "
                             f"vs {tuple(self.shape)}")
        self.copy_(raw)

    def numpy(self, *, force=False):
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()


_UID_COUNTER = itertools.count(1)


def stable_uid(t) -> int:
    """A process-unique id for a Tensor or Parameter, assigned on first
    use; never reused after the object is collected, unlike ``id()``."""
    uid = getattr(t, "_uid", None)
    if uid is None:
        uid = next(_UID_COUNTER)
        t._uid = uid
    return uid


# the funnel and the engine import Tensor, so they come last
from . import autograd_engine as _ag  # noqa: E402
from ..ops import dispatch as _dispatch  # noqa: E402
