"""Data-parallel training (counterpart of
``paddle_tpu/distributed/parallel.py``; reference
``fluid/dygraph/parallel.py:380`` ``DataParallel`` and its C++ reducer).

The JAX package expresses data parallelism as sharding: the *global*
batch is sharded over the mesh's ``dp`` axis, the parameters are
replicated, and the partitioner inserts the gradient all-reduce. The
port keeps that contract on DTensors: ``DataParallel`` replicates the
parameters (and buffers) over the mesh, broadcasts them from rank 0 so
every replica starts equal, and shards each global input's batch dim
over ``dp``. The gradient of a replicated parameter is then partial over
``dp``, and ``mesh.reduce_grad`` all-reduces it once: inside
``Model.train_batch``'s step (on NCCL part of the captured CUDA graph),
or after ``loss.backward()`` in ``apply_collective_grads`` or
``Optimizer.step``. The gradients equal those of the global-mean
loss. ``bf16_allreduce`` sums
the partial gradients in bfloat16 on the wire (the reference's
``fp16_allreduce``), ``compressed_allreduce`` through the block-scaled
int8 (or bf16) exchange of ``collective.py``.

``comm_buffer_size`` and ``find_unused_parameters`` are taken for the
reference's signature: one reduction a gradient leaves nothing to
bucket, and every replica runs the same program.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..nn.layer_base import Layer
from . import collective as C
from . import env as _env
from . import mesh as _mesh

__all__ = ["DataParallel", "sync_params_buffers", "shard_batch",
           "build_global_batch", "replicate_model"]


def _dp_axis_size(mesh) -> int:
    return _mesh.mesh_axis_size("dp", mesh)


@torch.no_grad()
def sync_params_buffers(model, comm_group=None, src_rank=0,
                        is_model_parallel=False):
    """Broadcast every parameter and buffer from ``src_rank`` so every
    replica starts equal (reference ``parallel.py``
    ``sync_params_buffers``). A parameter laid out on the mesh already
    holds its global value's slice on every rank and is left alone."""
    if not _env.is_initialized() or _env.get_world_size() <= 1:
        return
    g = C._get_group(comm_group)
    for _, t in list(model.named_parameters()) + list(model.named_buffers()):
        if not _mesh.is_dtensor(t):     # a laid-out one is equal already
            C.broadcast(t.detach(), src_rank, group=g)


def _swap_buffers(model, mesh):
    """Lay every buffer out replicated over ``mesh`` (in place of the
    plain one, where its module holds it)."""
    for mod in model.modules():
        for name, b in list(mod._buffers.items()):
            if b is not None and not _mesh.is_dtensor(b):
                mod._buffers[name] = _mesh.replicated(b, mesh)


def replicate_model(model, mesh=None):
    """Every parameter of ``model`` not laid out yet becomes a replicated
    DTensor parameter on ``mesh`` (default the global one), and so does
    every buffer. Returns ``model``."""
    m = mesh or _mesh.ensure_mesh()
    for _, p in list(model.named_parameters()):
        if not _mesh.is_dtensor(p):
            _mesh.shard_tensor(p, (), m)
    _swap_buffers(model, m)
    return model


def _dp_reduce(p, mesh, wire):
    """``p._grad_reduce``: the partial-over-``dp`` gradient summed on the
    ``wire`` ("bf16", or "int8"/"bf16" compressed), into ``p``'s
    placements."""
    from torch.distributed.tensor import DTensor, Partial
    names = tuple(mesh.mesh_dim_names or ())
    i = names.index("dp")
    group = C.Group(axis="dp", gid=-1, name="dp")

    def reduce(g):
        pl = list(g.placements)
        if not isinstance(pl[i], Partial) or \
                any(isinstance(q, Partial) for j, q in enumerate(pl)
                    if j != i):
            return g.redistribute(p.device_mesh, p.placements)
        loc = g.to_local()
        if wire == "bf16_allreduce":
            out = C._raw_all_reduce(loc.to(torch.bfloat16), C.ReduceOp.SUM,
                                    group).to(loc.dtype)
        else:
            out = C._raw_compressed_allreduce(loc, group, wire)
        pl[i] = p.placements[i]
        done = DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=g.shape, stride=g.stride())
        return done.redistribute(p.device_mesh, p.placements)
    return reduce


class DataParallel(Layer):
    """reference: ``fluid/dygraph/parallel.py:380`` (module docstring)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, bf16_allreduce=False,
                 compressed_allreduce=False,
                 compressed_allreduce_dtype="int8"):
        super().__init__()
        self._layers = layers
        self._group = group
        self._bf16_allreduce = bool(bf16_allreduce)
        if compressed_allreduce_dtype not in ("int8", "bf16"):
            raise ValueError(
                "compressed_allreduce_dtype must be 'int8' or 'bf16', "
                f"got {compressed_allreduce_dtype!r}")
        self._compressed_allreduce = bool(compressed_allreduce)
        self._compressed_dtype = str(compressed_allreduce_dtype)
        self._mesh = _mesh.ensure_mesh()
        self.find_unused_parameters = find_unused_parameters
        sync_params_buffers(layers, comm_group=group)
        replicate_model(layers, self._mesh)
        wire = (self._compressed_dtype if self._compressed_allreduce else
                "bf16_allreduce" if self._bf16_allreduce else None)
        if wire is not None and _dp_axis_size(self._mesh) > 1:
            for _, p in layers.named_parameters():
                if p.is_floating_point():
                    p._grad_reduce = _dp_reduce(p, self._mesh, wire)

    def _shard_input(self, x):
        raw = x._data if isinstance(x, Tensor) else x
        if not isinstance(raw, torch.Tensor) or raw.dim() == 0 or \
                _mesh.is_dtensor(raw):
            return x
        n = _dp_axis_size(self._mesh)
        if raw.shape[0] % n != 0:
            # the JAX package keeps such a batch whole on every device; a
            # rank here would then run the whole batch, without telling
            raise ValueError(
                f"DataParallel: a batch of {raw.shape[0]} rows does not "
                f"divide over the dp degree {n}")
        return shard_batch(x, self._mesh)

    def forward(self, *inputs, **kwargs):
        inputs = tuple(self._shard_input(x) for x in inputs)
        kwargs = {k: self._shard_input(v) for k, v in kwargs.items()}
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """reference ``parallel.py:586``: the identity (the global mean over
        the sharded batch carries the 1/nranks)."""
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """reference ``parallel.py:595``: every ``.grad`` that
        ``loss.backward()`` left partial over ``dp`` reduced in place
        (on this model's wire). ``Optimizer.step`` reduces what is still
        partial, and ``Model``'s step reduces inside itself."""
        for p in self._layers.parameters():
            if p.grad is not None:
                p.grad = _mesh.reduce_grad(p, p.grad)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    load_dict = set_state_dict

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)


def shard_batch(tensor, mesh=None, axis="dp"):
    """Lay a global batch out over ``axis`` (its dim 0); a mesh without
    the axis leaves it as it is."""
    m = mesh or _mesh.ensure_mesh()
    if axis not in tuple(m.mesh_dim_names or ()):
        return tensor
    raw = tensor._data if isinstance(tensor, Tensor) else tensor
    if not isinstance(raw, torch.Tensor):
        raw = torch.as_tensor(np.asarray(raw))
        tensor = raw
    spec = (axis,) + (None,) * (raw.dim() - 1)
    return _mesh.shard_tensor(tensor, spec, m)


def build_global_batch(local_np, mesh=None, axis="dp"):
    """Each rank's local batch (its slice of ``axis``) as one global
    DTensor sharded over ``axis`` (the reference's trainers each feed
    their own shard); in a world of one the array is the global batch.
    Ranks that share an ``axis`` coordinate must pass the same rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m = mesh or _mesh.ensure_mesh()
    dev = _env._rank_device() if _env.is_initialized() else None
    arr = torch.as_tensor(np.asarray(local_np))
    if dev is not None:
        arr = arr.to(dev)
    names = tuple(m.mesh_dim_names or ())
    if _env.get_world_size() <= 1 or axis not in names:
        return Tensor._wrap(shard_batch(arr, m, axis))
    pl = [Shard(0) if n == axis else Replicate() for n in names]
    return Tensor._wrap(DTensor.from_local(arr, m, pl, run_check=False))
