"""The dispatch funnel every functional op of the port goes through
(counterpart of ``paddle_tpu/ops/dispatch.py``, the reference's
Tracer::TraceOp).

:func:`apply` ``(name, fn, *args, **attrs)``, in order:

1. unwraps :class:`~paddle_tpu_torch.core.tensor.Tensor` arguments to
   their torch tensors (at any pytree position of ``args``, and at the
   top level of ``attrs``);
2. runs the AMP handler (:func:`register_amp_handler`; ``amp`` registers
   its ``cast_inputs``) on the positional arguments under the op's
   name: the cast hook the JAX package runs here, on every torch tensor
   among them, so ``attrs`` are never cast;
3. calls ``fn(*args, **attrs)`` on torch tensors; torch autograd records
   it where an input requires a gradient (the JAX package records a tape
   node here);
4. with ``FLAGS_check_nan_inf`` on, raises ``EnforceNotMet`` naming the
   op if a floating output holds a NaN or an Inf, except inside a CUDA
   graph capture, whose values do not exist yet (the JAX package skips
   traced values, ``:317``; a sync would break the capture);
5. records the op in :data:`OP_REGISTRY`;
6. wraps the outputs into Tensors, only when a Tensor came in: raw torch
   tensors in give raw torch tensors out, so every path that hands the
   ops torch tensors (the layers' internals, ``Model``, the engines, the
   captured programs) keeps its types and pays only the funnel's checks.

Inside a branch that ``ops.cond`` selects under a capture,
:data:`_BRANCH_GATE` gates the gradient of every input before step 3
(``ops/control_flow.py``). Flat arguments take a fast path with no
pytree flattening. A captured
program's replay runs none of this. While :data:`_PROF_ACTIVE` is set
(``profiler._ACTIVE``: a ``paddle_tpu_torch.profiler.Profiler`` runs)
each op runs inside ``torch.profiler.record_function("op::" + name)``. The port runs eagerly
only: :func:`enable_static` raises.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.errors import EnforceNotMet
from ..core.flags import _REGISTRY as _FLAGS
from ..core.tensor import Tensor
from ..profiler import _ACTIVE as _PROF_ACTIVE

__all__ = ["apply", "apply_raw", "OP_REGISTRY", "registered_ops",
           "register_op", "defop", "register_amp_handler",
           "in_dygraph_mode", "enable_static", "disable_static",
           "capturing", "host_array"]

#: op name -> the most recent implementation run under it (reference:
#: OpInfoMap); every op that has run in this process is here
OP_REGISTRY = {}

#: ``fn(op_name, args) -> args``, the AMP cast hook, or None
_AMP_HANDLER = [None]
#: ``fn(tensors) -> tensors`` gating the gradients of a branch that
#: ``ops.cond`` selects between under a capture, or None
_BRANCH_GATE = [None]
_NAN_INF = _FLAGS["check_nan_inf"]


def registered_ops():
    return sorted(OP_REGISTRY)


def register_amp_handler(fn):
    _AMP_HANDLER[0] = fn


def in_dygraph_mode() -> bool:
    return True


def enable_static():
    raise NotImplementedError(
        "static graph mode is not ported yet (ROADMAP queue A11): the "
        "port runs eagerly; Model.train_batch and the engines capture "
        "CUDA graphs instead")


def disable_static():
    """A no-op: the port is always in dygraph mode."""


def capturing() -> bool:
    """True inside a CUDA graph capture on the current stream: the port's
    counterpart of the JAX package's tracer, where no value can be read
    on the host."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def host_array(op: str, what: str, x) -> np.ndarray:
    """``x`` (a Tensor, torch tensor or host data) as a NumPy array read on
    the host for op ``op``; raises ``ValueError`` inside a capture (the
    JAX package fails the same read under a tracer)."""
    if capturing():
        raise ValueError(f"{op} reads {what} on the host, which a CUDA "
                         f"graph capture cannot do; call it outside the "
                         f"captured program")
    x = x._data if isinstance(x, Tensor) else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def apply(name: str, fn: Callable, *args, **attrs):
    """Run op ``name``, implemented by ``fn`` over torch tensors, through
    the funnel (module docstring)."""
    if _PROF_ACTIVE[0]:
        with torch.profiler.record_function("op::" + name):
            return _run(name, fn, args, attrs)
    return _run(name, fn, args, attrs)


def _run(name, fn, args, attrs):
    wrap = nested = False
    for a in args:
        if isinstance(a, Tensor):
            wrap = True
        elif isinstance(a, (list, tuple, dict)):
            nested = True
    if attrs:
        for k, v in attrs.items():
            if isinstance(v, Tensor):
                attrs[k] = v._data
                wrap = True
    handler = _AMP_HANDLER[0]
    gate = _BRANCH_GATE[0]
    if nested:
        leaves, spec = pytree.tree_flatten(args)
        if any(isinstance(x, Tensor) for x in leaves):
            wrap = True
            leaves = [x._data if isinstance(x, Tensor) else x
                      for x in leaves]
        if handler is not None:
            leaves = handler(name, leaves)
        if gate is not None:
            leaves = gate(leaves)
        args = pytree.tree_unflatten(list(leaves), spec)
    else:
        if wrap:
            args = tuple(a._data if isinstance(a, Tensor) else a
                         for a in args)
        if handler is not None:
            args = handler(name, args)
        if gate is not None:
            args = gate(args)
    if gate is not None and attrs:
        keys = list(attrs)
        attrs = dict(zip(keys, gate([attrs[k] for k in keys])))
    out = fn(*args, **attrs)
    if _NAN_INF.value:
        _check_nan_inf(name, out)
    OP_REGISTRY[name] = fn
    if not wrap:
        return out
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out)
    return pytree.tree_map_only(torch.Tensor, Tensor._wrap, out)


def apply_raw(name: str, fn: Callable, *args, **attrs):
    """:func:`apply` outside autograd (optimizer updates, statistics)."""
    with torch.no_grad():
        return apply(name, fn, *args, **attrs)


def _check_nan_inf(name, out):
    for o in pytree.tree_leaves(out):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            continue
        if o.is_cuda and torch.cuda.is_current_stream_capturing():
            continue
        if not bool(torch.isfinite(o).all()):
            raise EnforceNotMet(
                f"Operator '{name}' produced NaN/Inf (FLAGS_check_nan_inf "
                f"is on; reference: nan_inf_utils_detail.cc:411).")


def register_op(name):
    """Decorator registering a functional op under ``name``."""
    def deco(fn):
        OP_REGISTRY[name] = fn
        return fn
    return deco


def defop(name: str, impl: Callable):
    """A user-facing op that runs ``impl`` through the funnel under
    ``name``."""
    OP_REGISTRY[name] = impl

    def op(*args, **kw):
        return apply(name, impl, *args, **kw)
    op.__name__ = name
    return op
