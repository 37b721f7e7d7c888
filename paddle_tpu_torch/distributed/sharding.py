"""ZeRO: optimizer states, gradients and parameters sharded over ``dp``
(counterpart of ``paddle_tpu/distributed/sharding.py``; reference
``meta_optimizers/sharding_optimizer.py:43`` and
``distributed/sharding/group_sharded.py``).

Each level is a set of DTensor placements over the data axis, as each is
a set of ``PartitionSpec``s in the JAX package:

- ``"os"`` (stage 1): every optimizer state is sharded on its dim 0 over
  ``dp`` where that divides. The update reads the gradient where the
  state lives (a local slice of a replicated gradient) and the parameter
  gathers its update: the reference's stage-1 pattern;
- ``"os_g"`` (stage 2): also each gradient is reduced straight into that
  sharded layout (a reduce-scatter where stage 1 all-reduces);
- ``"p_g_os"`` (stage 3): also the parameters are sharded on dim 0 (the
  operations that read them gather them).

The port's optimizers update their state in place, DTensors included;
``Model.train_loop`` coalesces parameters into flat buffers and refuses
a model on a mesh (``train_batch`` runs it).
"""
from __future__ import annotations

from typing import Optional

from . import mesh as _mesh
from .parallel import replicate_model

__all__ = ["shard_optimizer_states", "shard_parameters",
           "group_sharded_parallel"]


def _spec_for(shape, axis, mesh) -> Optional[tuple]:
    """Dim 0 over ``axis`` when it divides; else None (replicated)."""
    n = _mesh.mesh_axis_size(axis, mesh)
    if n <= 1 or not shape or shape[0] % n != 0:
        return None
    return (axis,) + (None,) * (len(shape) - 1)


def _placements_with(p, axis, mesh):
    """``p``'s placements with dim 0 sharded over ``axis`` (when it
    divides and dim 0 is not sharded already)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = list(p.placements)
    names = tuple(mesh.mesh_dim_names or ())
    i = names.index(axis)
    taken = any(isinstance(q, Shard) and q.dim == 0 for q in pl)
    if _spec_for(tuple(p.shape), axis, mesh) is None or taken or \
            not isinstance(pl[i], Replicate):
        return None
    pl[i] = Shard(0)
    return pl


def _rebind_optimizer(optimizer):
    """Point ``optimizer`` at the DTensor parameters that replaced the
    ones it was built with."""
    new = [_mesh.swapped(p) for p in optimizer._parameter_list]
    optimizer._names = {id(q): optimizer._names.get(id(p), "")
                        for p, q in zip(optimizer._parameter_list, new)}
    optimizer._parameter_list = new


def _laid_out(st, p, pl, mesh):
    """The state dict ``st`` of ``p`` with every tensor of ``p``'s shape
    laid out as ``pl``."""
    return {k: (v.redistribute(mesh, pl) if _mesh.is_dtensor(v)
                and tuple(v.shape) == tuple(p.shape) else v)
            for k, v in st.items()}


def shard_optimizer_states(optimizer, mesh=None, axis="dp"):
    """ZeRO-1: every state tensor made sharded on dim 0 over ``axis``
    (module docstring); states made already are laid out anew."""
    m = mesh or _mesh.ensure_mesh()
    _rebind_optimizer(optimizer)
    orig_init = optimizer._init_state

    def sharded_init(p):
        st = orig_init(p)
        pl = _placements_with(p, axis, m) if _mesh.is_dtensor(p) else None
        return st if pl is None else _laid_out(st, p, pl, m)

    optimizer._init_state = sharded_init
    for i, st in list(optimizer._state.items()):
        p = optimizer._parameter_list[i]
        pl = _placements_with(p, axis, m) if _mesh.is_dtensor(p) else None
        if pl is not None:
            optimizer._state[i] = _laid_out(st, p, pl, m)
    return optimizer


def shard_gradients(model, mesh=None, axis="dp"):
    """ZeRO-2: each gradient reduced into dim 0 sharded over ``axis``."""
    m = mesh or _mesh.ensure_mesh()
    for _, p in model.named_parameters():
        if not _mesh.is_dtensor(p):
            continue
        pl = _placements_with(p, axis, m)
        if pl is not None:
            p._grad_reduce = (lambda g, pl=pl, p=p:
                              g.redistribute(p.device_mesh, pl))
    return model


def shard_parameters(model, mesh=None, axis="dp"):
    """ZeRO-3: each parameter laid out sharded on dim 0 over ``axis``
    (where it divides, keeping the placements it has on other axes); the
    operations that read it gather it."""
    m = mesh or _mesh.ensure_mesh()
    for _, p in list(model.named_parameters()):
        spec = _spec_for(tuple(p.shape), axis, m)
        if spec is None:
            continue
        if not _mesh.is_dtensor(p):
            _mesh.shard_tensor(p, spec, m)
            continue
        pl = _placements_with(p, axis, m)
        if pl is not None:
            _mesh.relayout_param(p, pl)
    return model


def group_sharded_parallel(model, optimizer, level="os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """reference: ``distributed/sharding/group_sharded.py``
    ``group_sharded_parallel(level in {"os", "os_g", "p_g_os"})``: the
    model replicated over the mesh (as ``DataParallel``) and sharded to
    the level; returns ``(model, optimizer, scaler)``."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"unknown sharding level {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True (host-memory optimizer states) is not supported; "
            "use more data-axis shards instead")
    m = _mesh.ensure_mesh()
    if level == "p_g_os":
        shard_parameters(model, m)
    replicate_model(model, m)
    if level in ("os_g", "p_g_os"):
        shard_gradients(model, m)
    shard_optimizer_states(optimizer, m)
    return model, optimizer, scaler
