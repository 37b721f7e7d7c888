"""Sequence parallelism: ring attention over an ``sp`` mesh axis
(counterpart of ``paddle_tpu/distributed/fleet/sequence_parallel.py``).

Q/K/V are global ``[B, H, T, D]`` tensors with the sequence dim sharded
over ``sp`` (DTensors; a plain tensor is taken as the global value on
every rank and sharded). Each rank keeps its query block and walks the
K/V ring: ``S`` steps of one block's attention, merged into a running
result, while the K/V block moves one rank forward (an explicit
point-to-point exchange, ``collective.permute``: the counterpart of
``shard_map`` plus ``ppermute``). The ring runs on the local shards
(``local_map``), so the kernels see plain local tensors.

- :func:`ring_attention`: dense ``[Tl, Tl]`` score blocks with a
  streaming softmax in float32, differentiable through autograd (the
  permute's backward is the reverse permute), as the JAX package's is
  through its scan.
- :func:`ring_flash_attention`: the flash kernels per block. The
  forward runs B1 on each (query block, K/V block) pair, which returns
  the block's output and row logsumexp, and merges them in float32
  (``lse' = logaddexp(lse, lse_c)``, ``o' = o·e^(lse-lse') +
  o_c·e^(lse_c-lse')``). Causality is positional: a past block runs the
  full kernel, the diagonal the causal one, and a future block launches
  nothing (its merge would change nothing), so rank ``r`` launches B1
  ``r + 1`` times. The backward (a ``torch.autograd.Function``) is the
  JAX package's second ring walk: with the merged (global) logsumexp,
  each block's ``exp(s·scale - lse)`` is already the global softmax
  weight, ``delta = rowsum(dO·O)`` is computed once, B2 and B3 run on
  each past and diagonal block with float32 outputs, dQ accumulates at
  home, and each K/V block's float32 dK/dV accumulator travels with it
  round the ring and is home after ``S`` moves.

The JAX package's ``_ring_blocks`` and the tuner's ``ring_flash*``
families have no counterpart: B1-B3's tiles are compile-time constants
(``tuner.autotune_flash`` raises). A ring of one rank is plain flash
attention, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.flash_attention import (attention_delta, flash_attention_bwd_dkv,
                                    flash_attention_bwd_dq,
                                    flash_attention_fwd)
from .. import collective as C
from .. import mesh as _mesh

__all__ = ["ring_attention", "ring_flash_attention", "RingAttention",
           "split_sequence", "gather_sequence"]

_NEG = -1e30  # the JAX package's -inf stand-in (keeps the algebra finite)


def _ring_group(mesh, axis) -> "C.Group":
    """The ``axis`` ring of this rank as a collective group."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names or mesh.size(names.index(axis)) == 1 or \
            not dist.is_initialized():
        return C.Group(ranks=[C._env.get_rank()], gid=-1, name=axis)
    pg = mesh.get_group(axis)
    return C.Group(ranks=dist.get_process_group_ranks(pg), gid=-1,
                   name=axis, pg=pg)


def _rotate(x, g):
    """Every rank's block to the next rank of the ring."""
    n = g.nranks
    return C.permute(x, [(i, (i + 1) % n) for i in range(n)], g)


def _placements(mesh, axis, batch_axes):
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    batch = () if batch_axes is None else (
        (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes))
    pl = []
    for n in names:
        pl.append(Shard(2) if n == axis else
                  Shard(0) if n in batch else Replicate())
    return pl


def _on_ring(fn, q, k, v, mesh, axis, batch_axes):
    """``fn(q, k, v, group)`` on the local ``[B, H, Tl, D]`` shards; the
    result laid out as the inputs."""
    from torch.distributed.tensor.experimental import local_map
    pl = _placements(mesh, axis, batch_axes)
    ts = []
    for t in (q, k, v):
        ts.append(t.redistribute(mesh, pl) if _mesh.is_dtensor(t)
                  else _mesh._distribute(t, mesh, pl))
    g = _ring_group(mesh, axis)
    return local_map(lambda a, b, c: fn(a, b, c, g), out_placements=pl,
                     in_placements=(pl, pl, pl), device_mesh=mesh)(*ts)


# -- the dense ring -------------------------------------------------------------

def _ring_dense_local(q, k, v, g, causal, scale):
    S, rank = g.nranks, g.rank
    B, H, Tl, D = q.shape
    f32 = torch.float32
    qpos = rank * Tl + torch.arange(Tl, device=q.device)
    o = torch.zeros((B, H, Tl, D), dtype=f32, device=q.device)
    m = torch.full((B, H, Tl), _NEG, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=f32, device=q.device)
    kc, vc = k, v
    for s in range(S):
        src = (rank - s) % S
        scores = torch.einsum("bhqd,bhkd->bhqk", q.to(f32),
                              kc.to(f32)) * scale
        if causal:
            kpos = src * Tl + torch.arange(Tl, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            scores = torch.where(mask, scores,
                                 torch.full_like(scores, _NEG))
        new_m = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - new_m[..., None])
        p = torch.where(scores <= _NEG, torch.zeros_like(p), p)
        corr = torch.exp(torch.clamp(m - new_m, _NEG, 0.0))
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               vc.to(f32))
        m = new_m
        if s < S - 1:
            kc, vc = _rotate(kc, g), _rotate(vc, g)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _scale_of(q, scale):
    return 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale


def ring_attention(q, k, v, mesh=None, axis: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   batch_axes=None):
    """Exact attention with the sequence dim of ``[B, H, T, D]`` sharded
    over ``axis`` (T a multiple of the axis size); ``batch_axes`` (e.g.
    "dp") names the axes the batch is sharded over. Returns the output
    laid out the same way (module docstring)."""
    m = mesh or _mesh.ensure_mesh()
    sc = _scale_of(q, scale)
    return _on_ring(lambda a, b, c, g: _ring_dense_local(a, b, c, g, causal,
                                                         sc),
                    q, k, v, m, axis, batch_axes)


# -- the flash ring -------------------------------------------------------------

def _bshd(t):
    """``[B, H, T, D]`` viewed as the kernels' ``[B, T, H, D]`` (last dim
    contiguous, no copy)."""
    return t.transpose(1, 2)


def _merge(o, lse, o_c, lse_c):
    """The float32 logsumexp merge of a block's ``(o_c [B,T,H,D], lse_c
    [B,H,T])`` into ``(o, lse)``."""
    lse_new = torch.logaddexp(lse, lse_c)
    w_old = torch.exp(torch.clamp(lse - lse_new, _NEG, 0.0))
    w_new = torch.exp(torch.clamp(lse_c - lse_new, _NEG, 0.0))
    o = o * w_old.transpose(1, 2)[..., None] + \
        o_c.to(torch.float32) * w_new.transpose(1, 2)[..., None]
    return o, lse_new


def _kind(src, rank, causal):
    """The block's kernel: "full" (a past block, or no mask), "causal"
    (the diagonal) or None (a future block: nothing to launch)."""
    if not causal:
        return "full"
    return "full" if src < rank else "causal" if src == rank else None


def ring_flash_forward(q, k, v, g, causal, scale):
    """The forward ring on local ``[B, H, Tl, D]`` blocks: ``(o [B, H, Tl,
    D] in q's type, lse [B, H, Tl] f32)``, the merged logsumexp being the
    backward's residual."""
    S, rank = g.nranks, g.rank
    B, H, Tl, D = q.shape
    qb = _bshd(q)
    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=q.device)
    kc, vc = k.contiguous(), v.contiguous()
    for s in range(S):
        kind = _kind((rank - s) % S, rank, causal)
        if kind is not None:
            o_c, lse_c = flash_attention_fwd(
                qb, _bshd(kc), _bshd(vc), kind == "causal", scale)
            o, lse = _merge(o, lse, o_c, lse_c)
        if s < S - 1:
            kc, vc = _move(kc, g), _move(vc, g)
    return o.to(q.dtype).transpose(1, 2), lse


def _move(x, g):
    """``x`` to the next rank of the ring, not differentiated (the
    backward ring moves its own accumulators)."""
    if g.nranks == 1:
        return x
    n = g.nranks
    return C._p2p_raw(x, [(i, (i + 1) % n) for i in range(n)], g)


def ring_flash_backward(q, k, v, o, lse, do, g, causal, scale):
    """The backward ring (module docstring): ``(dq, dk, dv)`` in the
    inputs' types, from the local blocks, the forward's output ``o`` and
    merged ``lse`` and the output gradient ``do``."""
    S, rank = g.nranks, g.rank
    f32 = torch.float32
    qb, ob = _bshd(q), _bshd(o)
    dob = _bshd(do.contiguous())
    delta = attention_delta(ob, dob)
    dq = torch.zeros(qb.shape, dtype=f32, device=q.device)
    dka = torch.zeros(_bshd(k).shape, dtype=f32, device=q.device)
    dva = torch.zeros_like(dka)
    kc, vc = k.contiguous(), v.contiguous()
    for s in range(S):
        kind = _kind((rank - s) % S, rank, causal)
        if kind is not None:
            dqc = flash_attention_bwd_dq(
                qb, _bshd(kc), _bshd(vc), dob, lse, delta,
                kind == "causal", scale, f32)
            dkc, dvc = flash_attention_bwd_dkv(
                qb, _bshd(kc), _bshd(vc), dob, lse, delta,
                kind == "causal", scale, f32, f32)
            dq += dqc
            dka += dkc
            dva += dvc
        dka, dva = _move(dka, g), _move(dva, g)
        if s < S - 1:
            kc, vc = _move(kc, g), _move(vc, g)
    return (dq.to(q.dtype).transpose(1, 2), dka.to(k.dtype).transpose(1, 2),
            dva.to(v.dtype).transpose(1, 2))


class RingFlashFunction(torch.autograd.Function):
    """The flash ring on local blocks: forward :func:`ring_flash_forward`,
    backward :func:`ring_flash_backward`. ``apply(q, k, v, group, causal,
    scale)`` returns the output."""

    @staticmethod
    def forward(ctx, q, k, v, g, causal, scale):
        o, lse = ring_flash_forward(q, k, v, g, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.g, ctx.causal, ctx.scale = g, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ring_flash_backward(q, k, v, o, lse, do, ctx.g,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_flash_attention(q, k, v, mesh=None, axis: str = "sp",
                         causal: bool = False, scale: Optional[float] = None,
                         batch_axes=None, interpret=None):
    """Sequence-parallel attention with the flash kernels per block (the
    contract of :func:`ring_attention`; module docstring). Differentiable.
    On CUDA the blocks launch B1-B3 (head dims 32, 64 and 128; the local
    sequence a multiple of 16, as the JAX package asks); on the CPU the
    kernels' plain versions run. ``interpret`` is the JAX package's
    Pallas switch and is refused when set."""
    if interpret:
        raise ValueError("ring_flash_attention: interpret mode is the JAX "
                         "package's Pallas switch; the port runs the CUDA "
                         "kernels or their plain versions by device")
    m = mesh or _mesh.ensure_mesh()
    sc = _scale_of(q, scale)
    n = _mesh.mesh_axis_size(axis, m)
    if q.shape[2] % n or (q.shape[2] // n) % 16:
        raise ValueError(f"ring_flash_attention: per-shard sequence "
                         f"{q.shape[2]}/{n} must be a multiple of 16")
    return _on_ring(lambda a, b, c, g: RingFlashFunction.apply(
        a, b, c, g, causal, sc), q, k, v, m, axis, batch_axes)


class RingAttention:
    """Layer-like wrapper that swaps a model's attention core for the
    ring (the ambient mesh); ``use_flash`` runs the flash ring."""

    def __init__(self, mesh=None, axis: str = "sp", causal: bool = False,
                 batch_axes=None, use_flash: bool = False):
        if mesh is not None and mesh is not _mesh.get_mesh():
            raise ValueError(
                "RingAttention uses the ambient mesh (set_mesh); pass "
                "mesh= only to ring_attention directly")
        self._axis = axis
        self._causal = causal
        self._batch_axes = batch_axes
        self._use_flash = use_flash

    def __call__(self, q, k, v):
        from ...core.tensor import Tensor
        raw = [t._data if isinstance(t, Tensor) else t for t in (q, k, v)]
        fn = ring_flash_attention if self._use_flash else ring_attention
        out = fn(*raw, axis=self._axis, causal=self._causal,
                 batch_axes=self._batch_axes)
        return Tensor._wrap(out) if isinstance(q, Tensor) else out


def split_sequence(x, mesh=None, axis: str = "sp", seq_dim: int = 2):
    """Shard a global tensor's sequence dim over ``axis``."""
    m = mesh or _mesh.ensure_mesh()
    spec = [None] * x.dim()
    spec[seq_dim] = axis
    return _mesh.constrain(x, tuple(spec), m)


def gather_sequence(x, mesh=None, axis: str = "sp", seq_dim: int = 2):
    """Replicate the sequence dim of a sequence-sharded tensor; its other
    dims keep their layout."""
    from torch.distributed.tensor import Replicate, Shard
    m = mesh or _mesh.ensure_mesh()
    if not _mesh.is_dtensor(x):
        return x
    pl = [Replicate() if isinstance(p, Shard) and p.dim == seq_dim else p
          for p in x.placements]
    return x.redistribute(m, pl)
