"""The device mesh (counterpart of ``paddle_tpu/distributed/mesh.py``).

The JAX package names communication axes of one global
``jax.sharding.Mesh`` and lays arrays out on it with ``NamedSharding``s;
GSPMD inserts the collectives. The port runs one process per rank, and
its mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group's ranks, with the JAX package's axis names and rank order
(row-major over the axes in the order given, :data:`HYBRID_AXES` for a
hybrid layout). A ``PartitionSpec`` tuple (an axis name, ``None`` or a
tuple of names a tensor dim) becomes DTensor placements: ``Shard(d)`` on
the mesh dims its axis names, ``Replicate()`` on the rest
(:func:`placements_for`). :func:`shard_tensor`, :func:`replicate_tensor`
and :func:`constrain` give a DTensor of the same *global* shape, so the
JAX package's global-shape contract (``state_dict`` names and shapes,
``tp_partition_specs``, ``shard_batch``) carries over, and DTensor's
sharding propagation inserts the collectives GSPMD would.

A DTensor never reaches a hand-written kernel: the layers that launch
one (attention) run it on the local shards through ``local_map``
(``nn/transformer.py``). :func:`is_dtensor`, :func:`like` and
:func:`local` are the helpers the layers use for that.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["HYBRID_AXES", "build_mesh", "set_mesh", "get_mesh",
           "ensure_mesh", "mesh_axis_size", "sharding_for", "constrain",
           "shard_tensor", "replicate_tensor", "placements_for",
           "is_dtensor", "like", "replicated", "embedding", "local", "full",
           "reduce_grad", "vocab_parallel_nll", "class_sharded_axis"]

_GLOBAL_MESH: list = [None]

#: canonical axis order for hybrid parallelism, the JAX package's:
#: dp outermost, then pp, sharding, sp, and mp innermost
HYBRID_AXES = ("dp", "pp", "sharding", "sp", "mp")


def _dtensor_types():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def is_dtensor(t) -> bool:
    """Is ``t`` a DTensor (without importing DTensor for plain code)."""
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    return isinstance(t, _dtensor_types()[0])


def build_mesh(axes: Optional[Dict[str, int]] = None, devices=None, *,
               device=None):
    """A ``DeviceMesh`` from an ``{axis: size}`` dict (order kept) over
    the process group's ranks, rank-major as the JAX package's
    ``np.array(devices).reshape(sizes)``. ``axes=None`` is a 1-D ``dp``
    mesh over every rank. ``devices`` may name the ranks (default all of
    them, in order); ``device`` the device type ("cuda" or "cpu",
    default the process group's device: the current CUDA device under
    NCCL or a CUDA rank, the CPU under gloo without one)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from .env import _require_initialized, _rank_device
    _require_initialized("build_mesh")
    ranks = list(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    if not axes:
        axes = {"dp": len(ranks)}
    names = tuple(axes.keys())
    sizes = tuple(int(s) for s in axes.values())
    total = int(np.prod(sizes))
    if total != len(ranks):
        raise ValueError(
            f"mesh {dict(axes)} needs {total} ranks, have {len(ranks)}")
    dev_type = device if isinstance(device, str) else (
        torch.device(device).type if device is not None
        else _rank_device().type)
    return DeviceMesh(dev_type, torch.tensor(ranks).reshape(sizes),
                      mesh_dim_names=names)


def set_mesh(mesh):
    _GLOBAL_MESH[0] = mesh


def get_mesh():
    return _GLOBAL_MESH[0]


def ensure_mesh():
    """The global mesh, made on first use as the 1-D ``dp`` mesh over
    every rank."""
    if _GLOBAL_MESH[0] is None:
        _GLOBAL_MESH[0] = build_mesh()
    return _GLOBAL_MESH[0]


def _axis_names(mesh):
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(axis, mesh=None) -> int:
    """The size of ``axis`` (or the product over a tuple of axes); 1
    without a mesh."""
    m = mesh or get_mesh()
    if m is None:
        return 1
    names = _axis_names(m)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([m.size(names.index(a)) for a in axis]))
    if axis not in names:
        return 1
    return int(m.size(names.index(axis)))


def placements_for(spec, mesh, ndim: Optional[int] = None):
    """DTensor placements of a ``PartitionSpec``-like tuple on ``mesh``:
    ``Shard(d)`` on the mesh dim of each axis named at tensor dim ``d``,
    ``Replicate()`` elsewhere. An axis the mesh lacks is refused (the
    JAX package's ``NamedSharding`` refuses it too)."""
    _, Replicate, Shard = _dtensor_types()
    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    spec = tuple(spec or ())
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more dims than the tensor "
                         f"({ndim})")
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
            if a not in names:
                raise ValueError(f"axis {a!r} is not in the mesh {names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} named twice in {spec}")
            out[i] = Shard(d)
    return out


def sharding_for(spec, mesh=None):
    """``(mesh, placements)`` of ``spec``: the port's ``NamedSharding``."""
    m = mesh or ensure_mesh()
    return m, placements_for(spec, m)


def _distribute(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t``'s global value (the same on every rank, as the
    JAX package's global arrays are) with ``placements``: each rank keeps
    its slice, no data moves, and the slice is differentiable."""
    from torch.distributed.tensor import DTensor
    _, _, Shard = _dtensor_types()
    if t.device.type != mesh.device_type:
        raise ValueError(
            f"a tensor on {t.device} on a {mesh.device_type} mesh; put it "
            f"on the mesh's device first")
    loc = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            # torch.chunk's split, as DTensor's Shard takes it
            parts = torch.chunk(loc, mesh.size(i), dim=p.dim)
            j = mesh.get_local_rank(i)
            loc = parts[j] if j < len(parts) else loc.narrow(p.dim, 0, 0)
    # a slice and from_local, both differentiable: a gradient reaches t
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def constrain(raw, spec, mesh=None):
    """``raw`` laid out as ``spec``: a plain tensor (the global value) is
    distributed, a DTensor redistributed (a real reshard, the
    counterpart of ``device_put``/``with_sharding_constraint``)."""
    m = mesh or ensure_mesh()
    pl = placements_for(spec, m, raw.dim())
    if is_dtensor(raw):
        return raw.redistribute(m, pl)
    return _distribute(raw, m, pl)


def shard_tensor(tensor, spec, mesh=None):
    """Lay ``tensor`` out as ``spec``. A parameter of a port ``Layer`` is
    replaced, in every layer that holds it, by a DTensor parameter of the
    same global value and attributes (a torch tensor cannot change its
    class in place), and that parameter is returned; a port ``Tensor``
    gets the DTensor as its payload; a plain tensor is returned as a
    DTensor. The spec is remembered (``_sharding_spec``)."""
    from ..core.tensor import Tensor
    if isinstance(tensor, Tensor):
        tensor._data = constrain(tensor._data, spec, mesh)
        tensor._sharding_spec = tuple(spec or ())
        tensor.is_distributed = True
        return tensor
    if isinstance(tensor, torch.nn.Parameter):
        return _shard_param(tensor, spec, mesh)
    return constrain(tensor, spec, mesh)


def replicate_tensor(tensor, mesh=None):
    return shard_tensor(tensor, (), mesh)


def _owners(p):
    from ..nn.layer_base import live_layers
    return [(m, n) for m in live_layers()
            for n, q in m._parameters.items() if q is p]


def _shard_param(p: torch.nn.Parameter, spec, mesh):
    m = mesh or ensure_mesh()
    return _swap_param(p, constrain(p.detach(), spec, m),
                       tuple(spec or ()))


def relayout_param(p: torch.nn.Parameter, placements):
    """Swap the DTensor parameter ``p`` for one laid out as
    ``placements`` (ZeRO-3's sharded parameters)."""
    return _swap_param(p, p.detach().redistribute(p.device_mesh,
                                                  placements),
                       p.__dict__.get("_sharding_spec"))


def _swap_param(p: torch.nn.Parameter, value, spec):
    owners = _owners(p)
    if not owners:
        raise ValueError("shard_tensor: the parameter belongs to no port "
                         "Layer, so there is nothing to swap it in")
    with torch.no_grad():
        new = torch.nn.Parameter(value, requires_grad=p.requires_grad)
    new.__dict__.update({k: v for k, v in p.__dict__.items()
                         if k != "_swapped_to"})
    new._sharding_spec = spec
    new.is_distributed = True
    for mod, name in owners:
        mod._parameters[name] = new
    # the replaced parameter points (weakly) at its successor, so an
    # optimizer built on the old list can follow (:func:`swapped`)
    p.__dict__["_swapped_to"] = weakref.ref(new)
    return new


def swapped(p):
    """The parameter that replaced ``p`` (``p`` itself if none did)."""
    while True:
        ref = p.__dict__.get("_swapped_to")
        nxt = ref() if ref is not None else None
        if nxt is None:
            return p
        p = nxt


def reduce_grad(p, g):
    """``g``, the gradient of the parameter ``p``, laid out as ``p``: a
    replicated parameter fed a batch sharded over ``dp`` gets a gradient
    partial over ``dp``, and one all-reduce here is what the JAX
    package's partitioner inserts (left partial, every optimizer op
    reading it would reduce it again). ``p._grad_reduce(g)``, where set
    (``DataParallel``'s bf16 or compressed wire, ZeRO-2's reduce-scatter),
    does it instead. ``Model``'s step, ``Optimizer.step`` and
    ``DataParallel.apply_collective_grads`` call it: a hook on the
    parameter would keep its gradient accumulator alive from the
    default stream, and a CUDA graph capturing the step could not
    capture the backward."""
    if g is None or not is_dtensor(g) or \
            tuple(g.placements) == tuple(p.placements):
        return g
    reduce = p.__dict__.get("_grad_reduce")
    if reduce is not None:
        return reduce(g)
    return g.redistribute(p.device_mesh, p.placements)


def _mesh_group(mesh, i):
    import torch.distributed as dist
    from . import collective as C
    pg = mesh.get_group(i)
    return C.Group(ranks=dist.get_process_group_ranks(pg), gid=-1,
                   name=f"mesh_dim_{i}", pg=pg)


def like(t: torch.Tensor, ref):
    """``t`` (a plain tensor holding the same global value on every
    rank) as a DTensor laid out like the DTensor ``ref`` where it can be
    (shards of ``ref``'s dims that ``t`` has, else replicated)."""
    _, Replicate, Shard = _dtensor_types()
    pl = [p if isinstance(p, Shard) and p.dim < t.dim()
          and t.shape[p.dim] == ref.shape[p.dim] else Replicate()
          for p in ref.placements]
    return _distribute(t, ref.device_mesh, pl)


def replicated(t: torch.Tensor, mesh):
    """``t`` (the same global value on every rank) as a replicated
    DTensor on ``mesh``."""
    _, Replicate, _ = _dtensor_types()
    return _distribute(t, mesh, [Replicate()] * mesh.ndim)


class _SumPartials(torch.autograd.Function):
    """The sum over a process group of each rank's partial value, into a
    replicated one; the gradient of a replicated value is the gradient of
    every partial (Megatron's reduction after a parallel lookup)."""

    @staticmethod
    def forward(ctx, x, group):
        from . import collective as C
        return C._raw_all_reduce(x.contiguous(), C.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def embedding(ids, weight):
    """``weight[ids]`` for a DTensor table, looked up where the table
    lies (``local_map``: it is never gathered). A table sharded on its
    rows (vocab-parallel) is looked up for the rows its shard holds,
    zeros elsewhere, and the partial lookups are summed over the sharding
    axis: the Megatron lookup the JAX package's partitioner derives. The
    local lookup is the plain path's indexing, so a mesh of one rank
    gives its values and gradients bit for bit."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = weight.device_mesh
    if not is_dtensor(ids):
        ids = replicated(ids, mesh)
    wpl = tuple(weight.placements)
    rows = [i for i, p in enumerate(wpl) if isinstance(p, Shard)]
    if len(rows) > 1 or (rows and wpl[rows[0]].dim != 0):
        raise ValueError(f"embedding table laid out {wpl}: only its rows "
                         f"may be sharded, over one axis")
    ax = rows[0] if rows else None
    lo, per, pg = 0, weight.shape[0], None
    if ax is not None:
        n = mesh.size(ax)
        if per % n:
            raise ValueError(f"vocab {per} is not a multiple of the "
                             f"{mesh.mesh_dim_names[ax]} axis ({n})")
        per //= n
        lo = mesh.get_local_rank(ax) * per
        # a sharding axis of one rank holds the whole table: the plain
        # lookup (no partials to sum)
        pg = _mesh_group(mesh, ax) if n > 1 else None
    ipl = [Replicate() if i == ax or isinstance(p, Partial) else p
           for i, p in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, ipl)

    def lookup(idl, wl):
        idl = idl.long()
        if pg is None:
            return wl[idl]
        idl = idl - lo
        inside = (idl >= 0) & (idl < per)
        out = wl[torch.where(inside, idl, torch.zeros_like(idl))]
        return _SumPartials.apply(out * inside[..., None].to(out.dtype), pg)
    # the table's gradient from this rank's rows of a batch sharded over
    # an axis is partial over that axis
    gpl = [Partial() if isinstance(ipl[i], Shard) else p
           for i, p in enumerate(wpl)]
    return local_map(lookup, out_placements=ipl, in_placements=(ipl, wpl),
                     in_grad_placements=(ipl, gpl),
                     device_mesh=mesh)(ids, weight)


class _VocabParallelCE(torch.autograd.Function):
    """``-log softmax(x)[label]`` a row, the classes sharded over a
    process group: the rows' max, sum of exponentials and the label's
    logit summed over the group (Megatron's parallel cross entropy).
    ``x`` is this rank's ``[N, V/n]`` shard, ``label`` the global class
    (0 where a row is ignored), ``lo`` the shard's first class."""

    @staticmethod
    def forward(ctx, x, label, lo, group):
        from . import collective as C
        m = C._raw_all_reduce(x.detach().amax(-1), C.ReduceOp.MAX, group)
        e = torch.exp(x - m[:, None])
        s = C._raw_all_reduce(e.sum(-1), C.ReduceOp.SUM, group)
        inside = (label >= lo) & (label < lo + x.shape[-1])
        idx = torch.where(inside, label - lo, torch.zeros_like(label))
        t = x.gather(-1, idx[:, None]).squeeze(-1) * inside.to(x.dtype)
        t = C._raw_all_reduce(t, C.ReduceOp.SUM, group)
        ctx.save_for_backward(e, s, idx, inside)
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        e, s, idx, inside = ctx.saved_tensors
        grad = e / s[:, None]
        grad.scatter_add_(-1, idx[:, None], -inside[:, None].to(grad.dtype))
        return grad * g[:, None], None, None, None


def class_sharded_axis(x, axis: int):
    """The mesh dim over which DTensor ``x`` shards its class ``axis``
    (of more than one rank), or None."""
    if not is_dtensor(x):
        return None
    axis = axis % x.dim()
    for i, p in enumerate(x.placements):
        if getattr(p, "dim", None) == axis and p.is_shard() and \
                x.device_mesh.size(i) > 1:
            return i
    return None


def vocab_parallel_nll(x, label, mesh_dim: int):
    """``-log softmax(x, -1)[label]`` for each row of the DTensor ``x``
    whose last (class) dim is sharded over ``mesh_dim``, computed where
    the shards lie (``local_map``, the Megatron parallel cross entropy):
    no rank gathers the logits. ``label`` (a DTensor laid out as ``x``'s
    rows) holds class ids, valid ones only. Returns the rows' losses,
    laid out as ``x``'s rows."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from . import collective as C
    mesh = x.device_mesh
    n, classes = mesh.size(mesh_dim), x.shape[-1]
    if classes % n:
        raise ValueError(f"{classes} classes are not a multiple of the "
                         f"{mesh.mesh_dim_names[mesh_dim]} axis ({n})")
    lo = mesh.get_local_rank(mesh_dim) * (classes // n)
    pg = mesh.get_group(mesh_dim)
    group = C.Group(ranks=dist.get_process_group_ranks(pg), gid=-1,
                    name="classes", pg=pg)
    xpl = tuple(x.placements)
    rpl = [Replicate() if i == mesh_dim else p for i, p in enumerate(xpl)]
    label = label.redistribute(mesh, rpl)

    def rows(xl, ll):
        flat = xl.reshape(-1, xl.shape[-1])
        out = _VocabParallelCE.apply(flat, ll.reshape(-1).long(), lo, group)
        return out.reshape(xl.shape[:-1])
    return local_map(rows, out_placements=rpl, in_placements=(xpl, rpl),
                     device_mesh=mesh)(x, label)


def local(t):
    """The local shard of a DTensor; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """The global value of a DTensor (gathered, partial values summed:
    DTensor's ``full_tensor``); a plain tensor as it is. In a gloo world
    of CUDA ranks the collectives it issues go through pinned host copies
    (``collective.stage_functional_collectives``)."""
    return t.full_tensor() if is_dtensor(t) else t
