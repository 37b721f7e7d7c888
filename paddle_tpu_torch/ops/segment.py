"""Segment reductions (counterpart of ``paddle_tpu/ops/segment.py``;
reference: operators/segment_pool_op.cc, incubate/tensor/math.py).

``segment_ids`` is ``[N]``, sorted ascending, possibly with gaps. Each
reduction is one scatter over the segments (``index_add`` for the sums,
``scatter_reduce`` for the extremes); an empty segment gives 0 for every
pool, the reference's convention. ``max``/``min`` split a gradient evenly
over tied entries of a segment, as the JAX package's ``segment_max``
does. Without ``num_segments`` the count is ``max(id) + 1``, read on the
host: one sync, refused inside a CUDA graph capture with the
``ValueError`` the JAX package raises under a tracer.
"""
from __future__ import annotations

import torch

from . import dispatch as _dispatch
from .dispatch import apply

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_pool"]


def _num_segments(segment_ids, num_segments):
    if num_segments is not None:
        return int(num_segments)
    if _dispatch.capturing():
        raise ValueError(
            "segment_* under a CUDA graph capture needs num_segments= (the "
            "output shape depends on the data); pass it explicitly.")
    ids = getattr(segment_ids, "_data", segment_ids)
    return int(ids.max()) + 1 if ids.shape[0] else 0


def _rows(ids, d):
    """``ids`` broadcast over the trailing axes of ``d``."""
    return ids.long().reshape((-1,) + (1,) * (d.dim() - 1)).expand_as(d)


def _sum(d, ids, n):
    out = torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                      device=d.device)
    return out.index_add(0, ids.long(), d)


def _mean(d, ids, n):
    s = _sum(d, ids, n)
    c = _sum(torch.ones(ids.shape, dtype=d.dtype, device=d.device), ids, n)
    c = c.reshape((n,) + (1,) * (d.dim() - 1))
    return torch.where(c > 0, s / torch.clamp(c, min=1), 0).to(d.dtype)


def _extreme(reduce):
    def impl(d, ids, n):
        out = torch.zeros((n,) + tuple(d.shape[1:]), dtype=d.dtype,
                          device=d.device)
        # include_self=False: an empty segment keeps the zero it starts at
        return out.scatter_reduce(0, _rows(ids, d), d, reduce,
                                  include_self=False)
    return impl


def segment_sum(data, segment_ids, num_segments=None, name=None):
    """Per-segment sums (segment_pool_op, pooltype SUM)."""
    return apply("segment_sum", _sum, data, segment_ids,
                 n=_num_segments(segment_ids, num_segments))


def segment_mean(data, segment_ids, num_segments=None, name=None):
    """Per-segment means (pooltype MEAN); empty segments give 0."""
    return apply("segment_mean", _mean, data, segment_ids,
                 n=_num_segments(segment_ids, num_segments))


def segment_max(data, segment_ids, num_segments=None, name=None):
    """Per-segment maxima (pooltype MAX); empty segments give 0."""
    return apply("segment_max", _extreme("amax"), data, segment_ids,
                 n=_num_segments(segment_ids, num_segments))


def segment_min(data, segment_ids, num_segments=None, name=None):
    """Per-segment minima (pooltype MIN); empty segments give 0."""
    return apply("segment_min", _extreme("amin"), data, segment_ids,
                 n=_num_segments(segment_ids, num_segments))


_POOLS = {"SUM": segment_sum, "MEAN": segment_mean, "MAX": segment_max,
          "MIN": segment_min}


def segment_pool(data, segment_ids, pooltype="SUM", num_segments=None,
                 name=None):
    """The raw op facade (segment_pool_op.cc:22, attribute ``pooltype``)."""
    try:
        fn = _POOLS[pooltype.upper()]
    except KeyError:
        raise ValueError(f"segment_pool: unknown pooltype {pooltype!r}; "
                         f"one of {sorted(_POOLS)}")
    return fn(data, segment_ids, num_segments=num_segments)
