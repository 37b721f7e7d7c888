"""``BeamSearchDecoder`` and ``dynamic_decode`` (counterpart of
``paddle_tpu/nn/beam_decode.py``; reference: nn/layer/rnn.py
BeamSearchDecoder :1103, dynamic_decode :1565).

The decode keeps the JAX package's fixed shapes: log-probabilities
``[B, K]``, a finished mask ``[B, K]`` and per-step (token, parent)
records stacked to ``[T, B, K]`` with ``T == max_step_num``, backtraced
at the end by ``ops.gather_tree``. A finished beam emits ``end_token``
at zero cost. Each step reorders every tensor leaf of the cell's state
by the chosen parents along axis 0; the state is a pytree
(``torch.utils._pytree``) whose leaves are the port's Tensors or torch
tensors, so a ``MultiHeadAttention.Cache`` namedtuple is reordered like
any other leaf. The top-k over ``K * V`` candidates is the port's
stable-sort top-k (the lower index first on ties, as ``lax.top_k``).
Nothing is read on the host, so a step can run inside a CUDA graph.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor, _raw
from ..ops.beam import gather_tree
from ..ops.math import _topk

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


class BeamSearchDecoder:
    """Wraps a cell into a beam-search step. ``cell(inputs, states) ->
    (outputs, new_states)``; ``embedding_fn`` maps token ids ``[B * K]``
    to the cell's inputs and ``output_fn`` its outputs to vocabulary
    logits (the reference's argument names)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _map_tensors(fn, tree):
    """``tree`` with ``fn`` applied to each tensor leaf's torch tensor; a
    Tensor leaf stays a Tensor, other leaves stay as they are."""
    def leaf(x):
        if isinstance(x, Tensor):
            return Tensor._wrap(fn(x._data))
        if isinstance(x, torch.Tensor):
            return fn(x)
        return x
    return pytree.tree_map(leaf, tree)


def dynamic_decode(decoder: BeamSearchDecoder, inits=None, max_step_num=32,
                   output_time_major=False, **kwargs):
    """Beam-search decoding for ``max_step_num`` steps. ``inits`` are the
    cell's initial states for a batch of ``B`` (each leaf ``[B, ...]``),
    tiled to the beam here. Returns ``(predicted_ids [B, T, K],
    final_scores [B, K])``: column ``k`` is the ``k``-th best sequence,
    backtraced through the parents with ``gather_tree``, and its
    accumulated log-probability; ``[T, B, K]`` with
    ``output_time_major``."""
    if kwargs:
        raise TypeError(
            f"dynamic_decode: unsupported keyword(s) {sorted(kwargs)}; "
            f"supported: inits, max_step_num, output_time_major "
            f"(impute_finished/return_length from the reference are not "
            f"implemented — lengths are derivable from end_token "
            f"positions in the fixed-shape output)")
    K = decoder.beam_size
    end = decoder.end_token
    leaves = [x for x in pytree.tree_leaves(inits)
              if isinstance(x, (Tensor, torch.Tensor))]
    if not leaves:
        raise ValueError("dynamic_decode needs initial cell states "
                         "(inits) to size the batch")
    first = _raw(leaves[0])
    B, dev = int(first.shape[0]), first.device
    states = _map_tensors(lambda t: torch.repeat_interleave(t, K, dim=0),
                          inits)

    neg = -1e9
    log_probs = torch.zeros((B, K), dtype=torch.float32, device=dev)
    log_probs[:, 1:] = neg
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    last_ids = torch.full((B * K,), decoder.start_token, dtype=torch.int64,
                          device=dev)
    base = (torch.arange(B, device=dev) * K)[:, None]
    step_ids, step_parents = [], []
    fmask = None
    for _ in range(int(max_step_num)):
        inp = Tensor._wrap(last_ids)
        if decoder.embedding_fn is not None:
            inp = decoder.embedding_fn(inp)
        out, new_states = decoder.cell(inp, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        lraw = _raw(logits)
        V = lraw.shape[-1]
        logp = torch.log_softmax(lraw.float(), dim=-1).reshape(B, K, V)
        if fmask is None:
            # finished beams: only end_token continues, at zero cost
            fmask = torch.full((V,), neg, device=dev)
            fmask[end] = 0.0
        logp = torch.where(finished[..., None], fmask, logp)
        scores = (log_probs[..., None] + logp).reshape(B, K * V)
        log_probs, top_idx = _topk(scores, K, -1, True)
        parent = top_idx // V
        token = top_idx % V
        finished = torch.take_along_dim(finished, parent, dim=1) | (
            token == end)
        gather = (base + parent).reshape(-1)
        states = _map_tensors(lambda t: t.index_select(0, gather),
                              new_states)
        last_ids = token.reshape(-1)
        step_ids.append(token)
        step_parents.append(parent)

    seqs = _raw(gather_tree(torch.stack(step_ids), torch.stack(step_parents)))
    predicted = seqs if output_time_major else seqs.permute(1, 0, 2)
    return Tensor._wrap(predicted), Tensor._wrap(log_probs)
