"""Control flow: ``cond``, ``while_loop``, ``case``, ``switch_case`` and the
tensor arrays (counterpart of ``paddle_tpu/ops/control_flow.py``;
reference: fluid/layers/control_flow.py cond :2334, while_loop :1076,
case :2788, switch_case :3099).

The JAX package has three contexts (``:9-21``); the port has these:

1. *Eager*: the predicate is read on the host (one sync, as the
   reference's dygraph) and the taken branch runs, recorded by autograd;
   ``while_loop`` is a Python loop.
2. *Inside a CUDA graph capture*, the port's counterpart of a trace:
   ``cond``, ``case`` and ``switch_case`` never read the predicate. Every
   branch runs and ``torch.where`` selects between output trees of the
   same structure, the value ``lax.cond`` gives for branches without side
   effects. Each op a branch runs gates the gradient of its inputs by
   the branch's predicate (:class:`_Gate`), so a NaN or Inf that the
   branch not taken makes in its backward (``sqrt`` of a negative input)
   stops at the branch's edge, as ``lax.cond``'s backward never runs the
   other branch. ``while_loop`` cannot be captured: its trip count lives
   on the device, and a graph replays a fixed sequence of kernels; it
   raises ``NotImplementedError``. (The JAX package's traced
   ``while_loop`` takes no reverse-mode gradient either, ``:13-16``.)
3. *Static Program*: not ported (ROADMAP queue A11); raises.

The arrays are Python lists of Tensors, as in the JAX package;
``increment`` adds in place.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor, _raw
from . import dispatch as _dispatch
from .math import increment  # noqa: F401 (the reference's is here too)

__all__ = ["cond", "while_loop", "case", "switch_case", "increment",
           "array_write", "array_read", "array_length", "create_array"]


def _refuse_static(op):
    if not _dispatch.in_dygraph_mode():
        raise NotImplementedError(
            f"{op} in a static Program is not ported (ROADMAP queue A11): "
            f"the port runs eagerly or as captured CUDA graphs")


def _selecting(pred):
    """True where ``pred`` is a device tensor inside a capture: the
    branches are selected between, not chosen on the host."""
    raw = _raw(pred)
    return isinstance(raw, torch.Tensor) and _dispatch.capturing()


def _truth(x) -> bool:
    raw = _raw(x)
    if isinstance(raw, torch.Tensor):
        return bool(raw.reshape(()).item())
    return bool(np.asarray(raw))


# -- the gradient gate of a selected branch ----------------------------------

class _Gate(torch.autograd.Function):
    """Identity forward; backward passes the gradient where ``pred`` holds
    and 0 elsewhere, NaN and Inf included."""

    @staticmethod
    def forward(ctx, x, pred):
        ctx.save_for_backward(pred)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pred, = ctx.saved_tensors
        return torch.where(pred, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device)), None


_GATE = threading.local()


def _gate_args(args):
    """``args`` with every tensor that needs a gradient gated by the
    innermost selected branch's predicate (called by the funnel)."""
    pred = getattr(_GATE, "pred", None)
    if pred is None:                    # another thread's op
        return args
    return tuple(_Gate.apply(a, pred) if isinstance(a, torch.Tensor)
                 and a.requires_grad else a for a in args)


def _run_gated(fn, pred):
    """``fn()`` with the funnel gating every op's inputs by ``pred`` (and
    the predicates of the branches it sits in)."""
    outer = getattr(_GATE, "pred", None)
    _GATE.pred = pred if outer is None else outer & pred
    prev = _dispatch._BRANCH_GATE[0]
    _dispatch._BRANCH_GATE[0] = _gate_args
    try:
        return fn() if fn is not None else None
    finally:
        _GATE.pred = outer
        _dispatch._BRANCH_GATE[0] = prev


def _select(pred, a, b):
    """``torch.where(pred, a, b)`` over two output trees of one
    structure; Tensors stay Tensors."""
    la, spec_a = pytree.tree_flatten(a)
    lb, spec_b = pytree.tree_flatten(b)
    if spec_a != spec_b:
        raise TypeError(f"cond: the branches return different structures "
                        f"({spec_a} and {spec_b}); under a capture both run "
                        f"and their outputs must match, as lax.cond's")
    out, wrap = [], False
    for x, y in zip(la, lb):
        rx, ry = _raw(x), _raw(y)
        if isinstance(rx, torch.Tensor) or isinstance(ry, torch.Tensor):
            if not (isinstance(rx, torch.Tensor)
                    and isinstance(ry, torch.Tensor)) or \
                    rx.dtype != ry.dtype:
                raise TypeError(f"cond: branch outputs {x!r} and {y!r} "
                                f"differ in type")
            wrap = isinstance(x, Tensor) or isinstance(y, Tensor)
            o = torch.where(pred, rx, ry)
            out.append(Tensor._wrap(o) if wrap else o)
        elif x is y or x == y:
            out.append(x)
        else:
            raise TypeError(f"cond: the branches return different Python "
                            f"values {x!r} and {y!r}")
    return pytree.tree_unflatten(out, spec_a)


# -- cond, case, switch_case --------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()`` (module docstring for
    the capture context)."""
    _refuse_static("cond")
    if not _selecting(pred):
        if _truth(pred):
            return true_fn() if true_fn is not None else None
        return false_fn() if false_fn is not None else None
    p = _raw(pred).reshape(()).bool()
    a = _run_gated(true_fn, p)
    b = _run_gated(false_fn, ~p)
    return _select(p, a, b)


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds runs; ``default`` (or the last
    pair's function) otherwise."""
    _refuse_static("case")
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        return cond(pred, fn, fn if default is None else default)
    return cond(pred, fn, lambda: case(rest, default))


def _as_pairs(branch_fns):
    if isinstance(branch_fns, dict):
        return sorted(branch_fns.items())
    if isinstance(branch_fns[0], (tuple, list)):
        return [tuple(p) for p in branch_fns]
    return list(enumerate(branch_fns))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch keyed by ``branch_index``; ``default``, or the last
    branch, when no key matches."""
    _refuse_static("switch_case")
    pairs = _as_pairs(branch_fns)
    if not _selecting(branch_index):
        raw = _raw(branch_index)
        i = int(raw.reshape(()).item()) if isinstance(raw, torch.Tensor) \
            else int(np.asarray(raw))
        for k, fn in pairs:
            if k == i:
                return fn()
        if default is not None:
            return default()
        return pairs[-1][1]()
    idx = _raw(branch_index).reshape(())

    def build(remaining):
        k, fn = remaining[0]
        if len(remaining) == 1:
            if default is not None:
                return cond(idx == k, fn, default)
            return fn()
        return cond(idx == k, fn, lambda: build(remaining[1:]))
    return build(pairs)


# -- while_loop ---------------------------------------------------------------

def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Run ``body_fn`` on ``loop_vars`` while ``cond_fn`` holds; a Python
    loop, recorded by autograd."""
    _refuse_static("while_loop")
    leaves = pytree.tree_leaves(list(loop_vars))
    if _dispatch.capturing() and any(
            isinstance(_raw(x), torch.Tensor) for x in leaves):
        raise NotImplementedError(
            "while_loop cannot run inside a CUDA graph capture: its trip "
            "count is read from the device, and a graph replays a fixed "
            "sequence of kernels (the JAX package lowers a traced "
            "while_loop to lax.while_loop); run it eagerly, or write the "
            "loop with a fixed trip count")
    state = list(loop_vars)
    while _truth(cond_fn(*state)):
        out = body_fn(*state)
        state = list(out) if isinstance(out, (list, tuple)) else [out]
    return state


# -- tensor arrays (reference: controlflow/write_to_array etc.) --------------

def create_array(dtype="float32", initialized_list=None):
    """A Python list in the LoDTensorArray's place."""
    return list(initialized_list or [])


def _index(i):
    raw = _raw(i)
    return int(raw.reshape(()).item()) if isinstance(raw, torch.Tensor) \
        else int(np.asarray(raw))


def array_write(x, i, array=None):
    if array is None:
        array = []
    i = _index(i)
    while len(array) <= i:
        array.append(None)
    array[i] = x
    return array


def array_read(array, i):
    return array[_index(i)]


def array_length(array):
    from .creation import to_tensor
    return to_tensor(np.int64(len(array)))
