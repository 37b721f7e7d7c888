"""The collective API (counterpart of
``paddle_tpu/distributed/collective.py``; reference
``python/paddle/distributed/collective.py``).

The JAX package lowers each collective to ``lax.psum``/``all_gather``/
``ppermute`` on a mesh axis inside a mapped trace, is the identity in a
world of one, and gathers on the host between processes. The port runs
one process per rank, so a collective is a ``torch.distributed`` call on
the group's process group:

- a group of one process (or no process group at all) is the identity,
  as in the JAX package;
- a group of several processes runs the c10d collective. A group is a
  c10d subgroup: ``new_group(ranks)`` makes one (every rank calls it, as
  in Paddle), and a mesh-axis group (``new_group(axis="mp")``, the
  hybrid topology's) is the mesh's own subgroup for this rank's slice.
  The JAX package's member masks are its way of doing the same;
- ``all_reduce`` (SUM and AVG), ``all_gather``, ``broadcast``,
  ``reduce_scatter``, ``alltoall`` and ``p2p_exchange`` are
  differentiable as the JAX ones are: ``all_reduce``'s backward is an
  ``all_reduce`` of the cotangent, ``all_gather``'s the reduce-scatter,
  a permute's the reverse permute;
- a gloo group's send and recv take a CUDA pointer for a host one and
  abort the process, and its CUDA collectives faulted the process on
  the card: every call of the port's collective layer on a gloo group
  with CUDA operands copies them through pinned host memory and back,
  explicitly, and counts it (:data:`HOST_STAGED`), and so do DTensor's
  collectives in a gloo world of CUDA ranks
  (:func:`stage_functional_collectives`). The compute stays on the card;
  a gloo timing says nothing about NCCL.

A port ``Tensor`` is updated in place (its payload swapped, so the
gradient flows), as the JAX package's ``_run``; a torch tensor that
needs no gradient is written in place, one that does gets the result
returned. ``send``/``recv`` are real point-to-point calls of this rank;
:func:`p2p_exchange` is the SPMD form every rank calls.

The compressed all-reduce (EQuARX-style, block-scaled int8 or bf16 on
the wire) is the JAX package's two-phase algorithm: quantize, all-to-all
the codes and scales (the reduce-scatter), dequantize and sum, quantize
the reduced shard again, all-gather, dequantize. Codes and scales are
bitwise the JAX package's (``round`` is half to even in both).
"""
from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.tensor import Tensor
from . import env as _env
from . import mesh as _mesh

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "destroy_process_group", "all_reduce", "reduce", "broadcast",
           "all_gather", "all_gather_object", "scatter", "reduce_scatter",
           "alltoall", "send", "recv", "p2p_exchange", "barrier", "wait",
           "compressed_all_reduce", "compressed_grad_sync",
           "compressed_allreduce_wire_bytes", "dense_allreduce_wire_bytes",
           "build_compressed_train_step", "get_rank", "get_world_size",
           "HOST_STAGED"]


class ReduceOp:
    """reference: distributed/collective.py:38 ReduceOp."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _c10d_op(op):
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


class Group:
    """A communication group (reference ``collective.py:76``): an explicit
    rank list or a mesh axis. ``pg`` is its c10d process group (None for
    the whole world)."""

    _next_id = [1]

    def __init__(self, ranks: Optional[Sequence[int]] = None,
                 axis: Union[str, Tuple[str, ...], None] = None,
                 gid: Optional[int] = None, name: Optional[str] = None,
                 pg=None):
        self.ranks = list(ranks) if ranks is not None else None
        self.axis = axis
        if gid is None:
            gid = Group._next_id[0]
            Group._next_id[0] += 1
        self.id = gid
        self.name = name or f"group_{gid}"
        self._pg = pg

    @property
    def pg(self):
        if self.axis is not None:
            return _axis_group(self.axis)
        return self._pg

    def _members(self) -> List[int]:
        """The global ranks of this rank's group, in group order."""
        if self.ranks is not None:
            return self.ranks
        if not _env.is_initialized():
            return [0]
        if self.axis is not None:
            pg = self.pg
            if pg is None:
                return [dist.get_rank()]
            return dist.get_process_group_ranks(pg)
        return list(range(dist.get_world_size()))

    @property
    def nranks(self):
        if self.axis is not None:
            return _axis_size(self.axis)
        if self.ranks is not None:
            return len(self.ranks)
        return _env.get_world_size()

    world_size = nranks

    @property
    def rank(self):
        return self.get_group_rank(_env.get_rank())

    def get_group_rank(self, rank):
        members = self._members()
        return members.index(rank) if rank in members else -1

    def is_member(self):
        return self.rank >= 0

    def __repr__(self):
        return f"Group(id={self.id}, axis={self.axis}, ranks={self.ranks})"


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_size(axis) -> int:
    m = _mesh.get_mesh()
    if m is None:
        return 1
    return int(np.prod([_mesh.mesh_axis_size(a, m) for a in _axes(axis)]))


def _axis_group(axis):
    """The mesh's process group along ``axis`` for this rank (None when
    the axis has one rank, or there is no mesh). A tuple of axes is one
    group only when at most one of them has more than one rank."""
    m = _mesh.get_mesh()
    if m is None:
        return None
    names = tuple(m.mesh_dim_names or ())
    live = [a for a in _axes(axis) if a in names
            and m.size(names.index(a)) > 1]
    if not live:
        return None
    if len(live) > 1:
        raise NotImplementedError(
            f"a group over the axes {live} at once; build it with "
            f"new_group(ranks) (every rank calls it)")
    return m.get_group(live[0])


_GLOBAL_GROUP = Group(gid=0, name="global")
_GROUP_MAP = {0: _GLOBAL_GROUP}


def _get_group(group) -> Group:
    if group is None:
        return _GLOBAL_GROUP
    if isinstance(group, Group):
        return group
    return _GROUP_MAP[int(group)]


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None, axis=None) -> Group:
    """reference: collective.py:205. ``ranks=`` makes a c10d subgroup (a
    collective call: every rank of the world calls it, members or not);
    ``axis=`` names a mesh axis (the hybrid topology's groups)."""
    pg = None
    if ranks is not None and axis is None and _env.is_initialized() \
            and dist.get_world_size() > 1:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(sorted(ranks), backend=backend, **kw)
    g = Group(ranks=ranks, axis=axis, pg=pg)
    _GROUP_MAP[g.id] = g
    return g


def get_group(gid: int) -> Group:
    return _GROUP_MAP[gid]


def is_initialized() -> bool:
    return _env.is_initialized()


def destroy_process_group(group=None):
    """Forget ``group`` (the JAX package's; the process group itself goes
    with ``env.destroy_process_group``)."""
    if group is not None:
        _GROUP_MAP.pop(_get_group(group).id, None)


# -- transport ------------------------------------------------------------------

#: operand copies through pinned host memory for a gloo group with CUDA
#: tensors: calls and bytes each way
HOST_STAGED = {"calls": 0, "bytes": 0}


def _pg_backend(pg) -> str:
    return dist.get_backend(pg)


def _staged(pg, *tensors):
    """Whether ``tensors`` go through host memory: a gloo group and CUDA
    operands."""
    return any(t is not None and t.is_cuda for t in tensors) and \
        _pg_backend(pg) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=torch.cuda.is_available())
    host.copy_(t)
    HOST_STAGED["bytes"] += t.numel() * t.element_size()
    return host


def _call(pg, fn, outs, ins):
    """``fn(outs, ins)`` on the c10d group. A gloo group with CUDA
    operands goes through pinned host copies of every operand (outputs
    copied back into ``outs``): gloo's send and recv write a CUDA pointer
    as a host one and abort the process, and its CUDA collectives take
    some reductions and types only; the host copies take them all."""
    flat = [t for t in outs + ins if t is not None]
    if not _staged(pg, *flat):
        fn(outs, ins)
        return
    HOST_STAGED["calls"] += 1
    if any(t.is_cuda for t in flat):
        torch.cuda.current_stream().synchronize()
    h_outs = [None if t is None else _to_host(t) for t in outs]
    h_ins = [None if t is None else _to_host(t) for t in ins]
    fn(h_outs, h_ins)
    for dst, src in zip(outs, h_outs):
        if dst is not None:
            dst.copy_(src)
            HOST_STAGED["bytes"] += src.numel() * src.element_size()


#: the CUDA kernels of torch's functional collectives, replaced for a gloo
#: world of CUDA ranks (:func:`stage_functional_collectives`)
_STAGED_LIB: list = [None]
_FUNCTIONAL = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")


def _staged_functional(name):
    op = getattr(torch.ops._c10d_functional, name).default
    wait = torch.ops._c10d_functional.wait_tensor.default

    def impl(x, *args):
        HOST_STAGED["calls"] += 1
        out = wait(op(_to_host(x.contiguous()), *args))
        HOST_STAGED["bytes"] += out.numel() * out.element_size()
        return out.to(x.device)
    return impl


def stage_functional_collectives():
    """Route the functional collectives DTensor issues (``torch.ops.
    _c10d_functional``'s all-reduce, all-gather, reduce-scatter,
    all-to-all and broadcast) on CUDA tensors through pinned host copies
    and the group's gloo CPU path, for the rest of the process. A gloo
    world of CUDA ranks calls it (``init_parallel_env``): gloo's own CUDA
    collectives faulted the process on the card (a segmentation fault in
    ``wait_tensor``, forward and backward alike). Counted in
    :data:`HOST_STAGED`."""
    if _STAGED_LIB[0] is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _FUNCTIONAL:
        lib.impl(name, _staged_functional(name), "CUDA")
    _STAGED_LIB[0] = lib


def _solo(g: Group) -> bool:
    """A world of one for this group, or a rank outside an explicit rank
    group: the identity (a non-member keeps its input, as the JAX
    package's masked collectives leave it)."""
    if not _env.is_initialized():
        return True
    if g.ranks is not None and _env.get_rank() not in g.ranks:
        return True
    if g.axis is not None:
        return g.pg is None
    return g.nranks <= 1


def _pg(g: Group):
    return g.pg if g.axis is not None else (g._pg if g.ranks is not None
                                            else None)


def _raw_all_reduce(x: torch.Tensor, op, g: Group) -> torch.Tensor:
    out = x.detach().clone()
    pg = _pg(g)
    _call(pg, lambda o, i: dist.all_reduce(o[0], _c10d_op(op), group=pg),
          [out], [])
    if op == ReduceOp.AVG:
        out = out / g.nranks if out.is_floating_point() else \
            torch.div(out, g.nranks, rounding_mode="floor")
    return out


def _raw_all_gather(x: torch.Tensor, g: Group) -> torch.Tensor:
    """``[n, *x.shape]``, every member's ``x`` in group order."""
    n = g.nranks
    flat = x.detach().contiguous().reshape(-1)
    out = torch.empty((n * flat.numel(),), dtype=x.dtype, device=x.device)
    pg = _pg(g)
    _call(pg, lambda o, i: dist.all_gather_into_tensor(o[0], i[0],
                                                       group=pg),
          [out], [flat])
    out = out.reshape((n,) + tuple(x.shape))
    if g.ranks is not None and g.ranks != sorted(g.ranks):
        # c10d orders a subgroup by global rank; the group's order is the
        # list it was made from
        order = sorted(g.ranks)
        out = out[[order.index(r) for r in g.ranks]]
    return out


def _raw_broadcast(x: torch.Tensor, src_global: int, g: Group):
    out = x.detach().clone().contiguous()
    pg = _pg(g)
    _call(pg, lambda o, i: dist.broadcast(o[0], src_global, group=pg),
          [out], [])
    return out


def _raw_all_to_all(x: torch.Tensor, g: Group) -> torch.Tensor:
    """Split dim 0 into ``n`` chunks, chunk ``j`` to member ``j``; the
    result concatenates what every member sent this rank, in order."""
    if g.ranks is not None:
        raise NotImplementedError(
            "alltoall/reduce_scatter over an arbitrary rank group; use a "
            "mesh-axis group (as the JAX package)")
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    pg = _pg(g)
    _call(pg, lambda o, i: dist.all_to_all_single(o[0], i[0], group=pg),
          [out], [x])
    return out


def _raw_reduce_scatter(x: torch.Tensor, op, g: Group) -> torch.Tensor:
    """Sum over members of ``x``'s dim-0 chunk ``rank``: an all-to-all of
    the chunks and a local sum, so gloo (which has no reduce-scatter)
    takes it too."""
    n = g.nranks
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not a "
                         f"multiple of the group size {n}")
    got = _raw_all_to_all(x, g).reshape((n, x.shape[0] // n)
                                        + tuple(x.shape[1:]))
    out = got.sum(0)
    return out / n if op == ReduceOp.AVG else out


# -- autograd -----------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, g):
        ctx.op, ctx.g = op, g
        return _raw_all_reduce(x, op, g)

    @staticmethod
    def backward(ctx, dy):
        return _raw_all_reduce(dy.contiguous(), ctx.op, ctx.g), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _raw_all_gather(x, g)

    @staticmethod
    def backward(ctx, dy):
        n = ctx.g.nranks
        red = _raw_all_reduce(dy.contiguous(), ReduceOp.SUM, ctx.g)
        return red.reshape((n,) + tuple(dy.shape[1:]))[ctx.g.rank], None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src_global, g):
        ctx.src, ctx.g = src_global, g
        return _raw_broadcast(x, src_global, g)

    @staticmethod
    def backward(ctx, dy):
        red = _raw_all_reduce(dy.contiguous(), ReduceOp.SUM, ctx.g)
        if _env.get_rank() != ctx.src:
            red = torch.zeros_like(red)
        return red, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _raw_all_to_all(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _raw_all_to_all(dy.contiguous(), ctx.g), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, g):
        ctx.op, ctx.g = op, g
        return _raw_reduce_scatter(x, op, g)

    @staticmethod
    def backward(ctx, dy):
        full = _raw_all_gather(dy.contiguous(), ctx.g)
        full = full.reshape((-1,) + tuple(dy.shape[1:]))
        if ctx.op == ReduceOp.AVG:
            full = full / ctx.g.nranks
        return full, None, None


def _p2p_raw(x: torch.Tensor, pairs, g: Group) -> torch.Tensor:
    """Every ``(src, dst)`` pair (group ranks) moves ``src``'s ``x`` to
    ``dst``; a rank that receives nothing keeps its own. One batch of
    isend/irecv, so a ring exchange cannot deadlock."""
    me = g.rank
    members = g._members()
    x = x.detach().contiguous()
    out = x.clone()
    pg = _pg(g)
    sends = [members[d] for s, d in pairs if s == me]
    recvs = [members[s] for s, d in pairs if d == me]
    if len(recvs) > 1:
        raise ValueError("p2p: a rank may receive from one source")

    def run(outs, ins):
        ops = [dist.P2POp(dist.isend, ins[0], peer, group=pg)
               for peer in sends]
        ops += [dist.P2POp(dist.irecv, outs[0], peer, group=pg)
                for peer in recvs]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    _call(pg, run, [out if recvs else None], [x])
    return out


class _Permute(torch.autograd.Function):
    """A permutation of the group's values (``pairs`` of group ranks);
    the backward runs the reverse permutation."""

    @staticmethod
    def forward(ctx, x, pairs, g):
        ctx.pairs, ctx.g = pairs, g
        return _p2p_raw(x, pairs, g)

    @staticmethod
    def backward(ctx, dy):
        me = ctx.g.rank
        dy = dy.contiguous()
        # a sender gets back its receiver's cotangent; a rank that kept
        # its value (received nothing) also keeps its own
        moved = _p2p_raw(dy, [(d, s) for s, d in ctx.pairs], ctx.g)
        received = any(d == me for _, d in ctx.pairs)
        grad = torch.zeros_like(dy) if received else dy
        if any(s == me for s, _ in ctx.pairs):
            grad = grad + moved
        return grad, None, None


def permute(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """Differentiable ``lax.ppermute`` over ``group`` (``pairs`` of group
    ranks); a rank nobody sends to keeps its value. A world of one is the
    identity."""
    g = _get_group(group)
    if _solo(g):
        return x
    return _Permute.apply(x, list(pairs), g)


# -- the functional API ---------------------------------------------------------

def _raw(t):
    return t._data if isinstance(t, Tensor) else t


def _finish(tensor, out):
    """Hand ``out`` back the way the reference's in-place collectives do
    (module docstring)."""
    if isinstance(tensor, Tensor):
        tensor._swap_payload(Tensor._wrap(out))
        return tensor
    if isinstance(tensor, torch.Tensor) and not tensor.requires_grad \
            and out.shape == tensor.shape:
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    return out


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=None):
    """reference: collective.py:410. SUM and AVG are differentiable
    (backward: the same all-reduce of the cotangent)."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    x = _raw(tensor)
    if _needs_grad(x):
        if op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise NotImplementedError(
                "all_reduce: only SUM and AVG carry a gradient (the JAX "
                "package's pmax/pmin have no transpose either)")
        out = _AllReduce.apply(x, op, g)
    else:
        out = _raw_all_reduce(x, op, g)
    return _finish(tensor, out)


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: collective.py:491. Every member computes the reduction,
    ``dst`` keeps it (a global rank, or a group rank of an explicit rank
    group, as the JAX package reads it), the others keep their input."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    x = _raw(tensor)
    red = _raw_all_reduce(x, op, g)
    dst_global = g.ranks[dst] if g.ranks is not None else dst
    out = red if _env.get_rank() == int(dst_global) else x.detach().clone()
    return _finish(tensor, out)


def broadcast(tensor, src, group=None, sync_op=True):
    """reference: collective.py:343. ``src`` is a global rank."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    x = _raw(tensor)
    out = _Broadcast.apply(x, int(src), g) if _needs_grad(x) else \
        _raw_broadcast(x, int(src), g)
    return _finish(tensor, out)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """reference: collective.py:585: fills ``tensor_list`` with every
    member's tensor and returns them stacked ``[n, ...]``."""
    g = _get_group(group)
    x = _raw(tensor)
    if g.ranks is not None and _env.is_initialized() and \
            _env.get_rank() not in g.ranks:
        raise ValueError(f"all_gather: rank {_env.get_rank()} is not a "
                         f"member of {g.ranks}")
    if _solo(g):
        stacked = x[None]
    elif _needs_grad(x):
        stacked = _AllGather.apply(x, g)
    else:
        stacked = _raw_all_gather(x, g)
    if isinstance(tensor, Tensor):
        stacked = Tensor._wrap(stacked)
    if tensor_list is not None:
        for i in range(int(stacked.shape[0])):
            tensor_list.append(stacked[i])
    return stacked


def all_gather_object(object_list, obj, group=None):
    """reference: collective.py all_gather_object (pickled)."""
    g = _get_group(group)
    if _solo(g):
        object_list.append(obj)
        return object_list
    data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    dev = _env._rank_device()
    size = torch.tensor([data.size], dtype=torch.int64, device=dev)
    n = int(_raw_all_reduce(size, ReduceOp.MAX, g).item())
    buf = torch.zeros(n + 8, dtype=torch.uint8)
    buf[:8] = torch.from_numpy(np.frombuffer(np.int64(data.size).tobytes(),
                                             np.uint8).copy())
    buf[8:8 + data.size] = torch.from_numpy(data.copy())
    rows = _raw_all_gather(buf.to(dev), g).cpu().numpy()
    for row in rows:
        size = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        object_list.append(pickle.loads(row[8:8 + size].tobytes()))
    return object_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """reference: collective.py:663: ``src`` (a global rank, a member)
    holds one tensor a member; each member receives its own."""
    g = _get_group(group)
    if _solo(g):
        if tensor_list:
            r = g.rank if g.ranks is not None else 0
            if r < 0:
                return tensor
            pick = _raw(tensor_list[r])
            return _finish(tensor, pick)
        return tensor
    if g.get_group_rank(int(src)) < 0:
        raise ValueError(f"scatter src={src} is not a member of group "
                         f"ranks {g._members()}")
    x = _raw(tensor)
    if _env.get_rank() == int(src):
        stack = torch.stack([_raw(t) for t in tensor_list]).to(x.device)
    else:
        stack = torch.empty((g.nranks,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
    full = _raw_broadcast(stack, int(src), g)
    return _finish(tensor, full[g.rank].clone())


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """reference: operators/collective/c_reducescatter_op.cc: the sum
    over members of dim-0 chunk ``rank`` (SUM and AVG)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError("reduce_scatter supports SUM/AVG")
    g = _get_group(group)
    src = tensor_or_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([_raw(t) for t in src], dim=0)
    src = _raw(src)
    if _solo(g):
        out = src
    elif _needs_grad(src):
        out = _ReduceScatter.apply(src, op, g)
    else:
        out = _raw_reduce_scatter(src, op, g)
    if tensor is None:
        return out
    return _finish(tensor, out)


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """reference: collective.py:1315: member ``j`` gets every member's
    ``j``-th tensor, in member order."""
    g = _get_group(group)
    xs = in_tensor_list
    single = not isinstance(xs, (list, tuple))
    stacked = _raw(xs) if single else torch.stack([_raw(x) for x in xs])
    if _solo(g):
        result = stacked
    elif _needs_grad(stacked):
        result = _AllToAll.apply(stacked, g)
    else:
        result = _raw_all_to_all(stacked, g)
    if out_tensor_list is not None and not single:
        for i in range(result.shape[0]):
            out_tensor_list.append(result[i])
    return result


def send(tensor, dst=0, group=None, sync_op=True, src=None):
    """reference: collective.py:1386: this rank sends ``tensor`` to
    global rank ``dst`` (``src``, the JAX package's SPMD spelling, must
    be this rank when given)."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    if src is not None and int(src) != _env.get_rank():
        return p2p_exchange(tensor, src, dst, group)
    x = _raw(tensor).detach().contiguous()
    pg = _pg(g)
    _call(pg, lambda o, i: dist.send(i[0], int(dst), group=pg), [], [x])
    return tensor


def recv(tensor, src=0, group=None, sync_op=True, dst=None):
    """reference: collective.py:1436: this rank receives into ``tensor``
    from global rank ``src``."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    if dst is not None and int(dst) != _env.get_rank():
        return p2p_exchange(tensor, src, dst, group)
    x = _raw(tensor)
    out = torch.empty_like(x.detach()).contiguous()
    pg = _pg(g)
    _call(pg, lambda o, i: dist.recv(o[0], int(src), group=pg), [out], [])
    return _finish(tensor, out)


def p2p_exchange(tensor, src, dst, group=None):
    """The SPMD point-to-point every member calls (the JAX package's):
    member ``src``'s value lands on member ``dst`` (group ranks); every
    other member keeps its own. Differentiable (the reverse move)."""
    g = _get_group(group)
    if _solo(g):
        return tensor
    x = _raw(tensor)
    pairs = [(int(src), int(dst))]
    out = _Permute.apply(x, pairs, g) if _needs_grad(x) else \
        _p2p_raw(x, pairs, g)
    return _finish(tensor, out)


def barrier(group=None):
    """reference: collective.py:165."""
    g = _get_group(group)
    if _solo(g):
        return None
    pg = _pg(g)
    dev = _env._rank_device()
    if _pg_backend(pg) == "nccl":
        dist.barrier(group=pg, device_ids=[dev.index])
    else:
        dist.barrier(group=pg)
    return None


def wait(tensor, group=None, use_calc_stream=True):
    """reference: collective.py:276: the port's collectives run on the
    caller's stream, so this blocks the host until the tensor's work is
    done (the JAX package's ``block_until_ready``)."""
    x = _raw(tensor)
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return tensor


def get_rank(group=None):
    g = _get_group(group)
    r = _env.get_rank()
    if g is _GLOBAL_GROUP:
        return r
    return g.get_group_rank(r)


def get_world_size(group=None):
    g = _get_group(group)
    if g is _GLOBAL_GROUP:
        return _env.get_world_size()
    return g.nranks


# -- the compressed all-reduce ------------------------------------------------

DEFAULT_COMPRESS_BLOCK = 256
_WIRE_DTYPES = ("int8", "bf16")


def _compress_block_for(nelems: int, wire_dtype: str) -> int:
    """Block size for the quantize stage: the tuner's cached winner for
    this size family if there is one, else 256."""
    from ..tuner import get_compress_block
    blk = get_compress_block(nelems, wire_dtype, device="cpu")
    return int(blk) if blk else DEFAULT_COMPRESS_BLOCK


def _block_quantize_int8(blocks: torch.Tensor):
    """``[..., block]`` f32 -> (int8 codes, f32 per-block absmax scales),
    the JAX package's arithmetic (divide, times 127, round half to even,
    clip)."""
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax,
                        torch.ones_like(absmax)).to(torch.float32)
    q = torch.clamp(torch.round(blocks / scale[..., None] * 127.0),
                    -127.0, 127.0).to(torch.int8)
    return q, scale


def _block_dequantize_int8(q, scale):
    return q.to(torch.float32) * (scale[..., None] / 127.0)


def _raw_compressed_allreduce(x: torch.Tensor, g: Group, wire_dtype="int8",
                              block: Optional[int] = None, mean=False):
    """The two-phase compressed all-reduce of ``x`` over ``g`` (module
    docstring); every member dequantizes the same gathered codes, so the
    results are bitwise equal across members."""
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(
            f"compressed allreduce wire dtype must be one of "
            f"{_WIRE_DTYPES}, got {wire_dtype!r}")
    n = g.nranks
    if n == 1 or _solo(g):
        return x
    orig_dtype = x.dtype
    blk = int(block or _compress_block_for(x.numel(), wire_dtype))
    flat = x.detach().to(torch.float32).reshape(-1)
    per = -(-flat.numel() // (n * blk)) * blk        # shard length
    flat = torch.nn.functional.pad(flat, (0, n * per - flat.numel()))
    shards = flat.reshape(n, per)
    if wire_dtype == "bf16":
        got = _raw_all_to_all(shards.to(torch.bfloat16), g)
        local = got.to(torch.float32).sum(0)
        full = _raw_all_gather(local.to(torch.bfloat16), g)
        out = full.to(torch.float32).reshape(-1)
    else:
        q, s = _block_quantize_int8(shards.reshape(n, per // blk, blk))
        gq = _raw_all_to_all(q, g)
        gs = _raw_all_to_all(s, g)
        local = _block_dequantize_int8(gq, gs).sum(0)
        q2, s2 = _block_quantize_int8(local)
        fq = _raw_all_gather(q2, g)
        fs = _raw_all_gather(s2, g)
        out = _block_dequantize_int8(fq, fs).reshape(-1)
    out = out[: x.numel()].reshape(x.shape)
    if mean:
        out = out / n
    return out.to(orig_dtype)


def compressed_allreduce_wire_bytes(nelems: int, world: int,
                                    wire_dtype="int8",
                                    block: Optional[int] = None) -> int:
    """Bytes one rank puts on the wire in the two-phase exchange: (world
    - 1) quantized shards a phase, the int8 wire charged its 4-byte
    block scales."""
    if world <= 1:
        return 0
    blk = int(block or DEFAULT_COMPRESS_BLOCK)
    per = -(-int(nelems) // (world * blk)) * blk
    if wire_dtype == "bf16":
        payload = per * 2
    elif wire_dtype == "int8":
        payload = per + (per // blk) * 4
    else:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}")
    return 2 * (world - 1) * payload


def dense_allreduce_wire_bytes(nelems: int, world: int,
                               itemsize: int = 4) -> int:
    """Bytes one rank sends in the dense two-phase all-reduce."""
    if world <= 1:
        return 0
    per = -(-int(nelems) // world)
    return 2 * (world - 1) * per * itemsize


def _axis_as_group(axis) -> Group:
    return Group(axis=axis, gid=-1, name=f"axis_{axis}")


def compressed_grad_sync(grads, axis: str = "dp", wire_dtype: str = "int8",
                         block: Optional[int] = None, mean: bool = True,
                         mesh=None):
    """The compressed gradient mean over a mesh axis, for hand-written
    data-parallel steps: each tensor of ``grads`` (a tensor, a list or
    tuple, or a dict) through :func:`_raw_compressed_allreduce`."""
    if mesh is not None and mesh is not _mesh.get_mesh():
        raise ValueError("compressed_grad_sync: pass the global mesh "
                         "(set_mesh) or none")
    g = _axis_as_group(axis)

    def one(t):
        return _raw_compressed_allreduce(t, g, wire_dtype, block, mean)
    if isinstance(grads, dict):
        return {k: one(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(one(t) for t in grads)
    return one(grads)


def compressed_all_reduce(tensor, op=ReduceOp.SUM, group=None,
                          wire_dtype: str = "int8",
                          block: Optional[int] = None):
    """:func:`all_reduce` with a block-scaled int8 (or bf16) wire (SUM and
    AVG only: quantization commutes with addition up to its bounded
    rounding, not with max/min/prod); ``DistributedStrategy.
    compressed_allreduce`` turns it on for ``DataParallel``."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(
            "compressed_all_reduce supports SUM/AVG only")
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(
            f"compressed allreduce wire dtype must be one of "
            f"{_WIRE_DTYPES}, got {wire_dtype!r}")
    g = _get_group(group)
    if g.ranks is not None:
        raise NotImplementedError(
            "compressed_all_reduce over an arbitrary rank group; use a "
            "mesh-axis group (dp)")
    if _solo(g):
        return tensor
    out = _raw_compressed_allreduce(_raw(tensor), g, wire_dtype, block,
                                    mean=(op == ReduceOp.AVG))
    return _finish(tensor, out)


def build_compressed_train_step(mesh, axis: str = "dp",
                                wire_dtype: str = "int8",
                                block: Optional[int] = None,
                                lr: float = 0.1):
    """The JAX package's compressed data-parallel step: linear
    regression, gradients of this rank's rows, :func:`
    compressed_grad_sync` instead of a dense mean, an SGD update.
    ``step(w, b, x, y)`` takes the replicated ``w``, ``b`` and the global
    ``x``, ``y`` (this rank reads its ``axis`` slice of rows) and returns
    the replicated ``(w, b, loss)``, equal on every rank."""
    if mesh is not _mesh.get_mesh():
        raise ValueError("build_compressed_train_step: install the mesh "
                         "first (distributed.set_mesh)")
    g = _axis_as_group(axis)

    def step(w, b, x, y):
        n, r = g.nranks, max(g.rank, 0)
        rows = x.shape[0] // n
        xl, yl = x[r * rows:(r + 1) * rows], y[r * rows:(r + 1) * rows]
        err = xl @ w + b - yl
        gw = xl.T @ err * (2.0 / rows)
        gb = err.mean(0) * 2.0
        gw, gb = compressed_grad_sync((gw, gb), axis=axis,
                                      wire_dtype=wire_dtype, block=block)
        loss = (err * err).mean()
        if not _solo(g):
            loss = _raw_all_reduce(loss, ReduceOp.AVG, g)
        return w - lr * gw, b - lr * gb, loss
    return step
