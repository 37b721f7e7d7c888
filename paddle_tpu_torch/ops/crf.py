"""Linear-chain CRF ops (counterpart of ``paddle_tpu/ops/crf.py``;
reference: operators/linear_chain_crf_op.h, crf_decoding_op.h,
chunk_eval_op.h).

``transition`` is ``[C + 2, C]``: row 0 the start weights, row 1 the stop
weights, rows 2.. the square transition matrix (the reference's layout).
Ragged batches are padded with lengths. The forward recursion and the
Viterbi pass are Python loops over ``T`` of ``[N, C, C]`` logsumexp and
max on device tensors; the lengths stay on the device (a step past a
row's length keeps its state by ``torch.where``), so both run inside a
CUDA graph with no host read. ``linear_chain_crf``'s gradients with
respect to emission and transition come from autograd through the loop.
``argmax`` keeps the first maximum, as ``jnp.argmax``. ``chunk_eval``
counts chunks on the host in NumPy, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dispatch as _dispatch
from .dispatch import apply

__all__ = ["linear_chain_crf", "crf_decoding", "viterbi_decode",
           "chunk_eval"]


def _lens(maybe, N, T, device):
    if maybe:
        return maybe[0].long()
    return torch.full((N,), T, dtype=torch.long, device=device)


def _crf_nll(em, tr, lab, *maybe_len):
    N, T, C = em.shape
    lab = lab.long()
    lens = _lens(maybe_len, N, T, em.device)
    start, stop, W = tr[0], tr[1], tr[2:]
    # logZ by the forward recursion
    alpha = start[None, :] + em[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + W[None], dim=1) + em[:, t]
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
    logZ = torch.logsumexp(alpha + stop[None, :], dim=1)
    # the labelled path's score
    t_idx = torch.arange(T, device=em.device)
    em_sc = torch.gather(em, 2, lab[:, :, None])[:, :, 0]
    em_score = torch.where(t_idx[None, :] < lens[:, None], em_sc, 0).sum(1)
    tr_sc = W[lab[:, :-1], lab[:, 1:]]                        # [N, T-1]
    tr_score = torch.where(t_idx[None, 1:] < lens[:, None], tr_sc,
                           0).sum(1)
    last = torch.gather(lab, 1, (lens - 1)[:, None])[:, 0]
    score = start[lab[:, 0]] + em_score + tr_score + stop[last]
    return (logZ - score)[:, None]


def linear_chain_crf(emission, transition, label, length=None, name=None):
    """The labelled path's negative log-likelihood, ``logZ - score``
    (linear_chain_crf_op.h:240). ``emission [N, T, C]``, ``transition
    [C + 2, C]``, ``label [N, T]``, ``length [N]`` (None: full length).
    Returns ``[N, 1]``."""
    args = (emission, transition, label) + (
        (length,) if length is not None else ())
    return apply("linear_chain_crf", _crf_nll, *args)


def _viterbi(em, W, start, stop, lens):
    """Best path ``[N, T]`` (0 past each length) and its score ``[N]``."""
    N, T, C = em.shape
    ident = torch.arange(C, device=em.device).expand(N, C)
    delta = start[None, :] + em[:, 0]
    back = []
    for t in range(1, T):
        best, arg = torch.max(delta[:, :, None] + W[None], dim=1)
        live = (t < lens)[:, None]
        delta = torch.where(live, best + em[:, t], delta)
        back.append(torch.where(live, arg, ident))
    final = delta + stop[None, :]
    score, tag = torch.max(final, dim=1)
    path = [tag]
    for arg in reversed(back):
        tag = torch.gather(arg, 1, tag[:, None])[:, 0]
        path.append(tag)
    full = torch.stack(path[::-1], dim=1)
    t_idx = torch.arange(T, device=em.device)[None, :]
    return torch.where(t_idx < lens[:, None], full, 0), score


def _crf_decode(em, tr, *rest, has_label, has_length):
    rest = list(rest)
    lab = rest.pop(0).long() if has_label else None
    N, T, C = em.shape
    lens = rest.pop(0).long() if has_length else \
        torch.full((N,), T, dtype=torch.long, device=em.device)
    full, _ = _viterbi(em, tr[2:], tr[0], tr[1], lens)
    if lab is not None:
        valid = torch.arange(T, device=em.device)[None, :] < lens[:, None]
        return ((full == lab) & valid).long()
    return full


def crf_decoding(emission, transition, label=None, length=None, name=None):
    """Viterbi decode (crf_decoding_op.h): the best tag path ``[N, T]``
    (0 past ``length``); with ``label``, the per-position correctness
    ``[N, T]`` (0/1) instead, as the reference's eval mode."""
    args = (emission, transition) + ((label,) if label is not None else ()) \
        + ((length,) if length is not None else ())
    return apply("crf_decoding", _crf_decode, *args,
                 has_label=label is not None, has_length=length is not None)


def _viterbi_sq(em, tr, *maybe_len, bos_eos):
    N, T, C = em.shape
    lens = _lens(maybe_len, N, T, em.device)
    if bos_eos:
        start, stop = tr[C - 2], tr[:, C - 1]
    else:
        start = stop = torch.zeros((C,), dtype=em.dtype, device=em.device)
    full, score = _viterbi(em, tr, start, stop, lens)
    return score, full


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """Viterbi over a square ``[C, C]`` transition (the paddle.text
    ``ViterbiDecoder`` shape). With ``include_bos_eos_tag``, tag ``C - 2``
    is BOS and ``C - 1`` EOS: row ``C - 2`` gives the start scores and
    column ``C - 1`` the stop scores (the JAX package's pinned layout,
    ``paddle_tpu/ops/crf.py:124-177``). Returns ``(scores [N],
    paths [N, T])``."""
    args = (potentials, transition_params) + (
        (lengths,) if lengths is not None else ())
    return apply("viterbi_decode", _viterbi_sq, *args,
                 bos_eos=include_bos_eos_tag)


# -- chunk_eval (a host metric, as the reference's CPU-only kernel) ----------

def _extract_chunks(tags, scheme, num_chunk_types, excluded=()):
    """``(chunk_type, begin, end)`` spans of a tag sequence under the
    reference's layout ``tag = chunk_type * num_tag_types + tag_type``
    (chunk_eval_op.h GetSegments; lenient conlleval-style parsing, so a
    stray continuation tag opens a chunk)."""
    try:
        n_tag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    except KeyError:
        raise ValueError(f"chunk_eval: unknown scheme {scheme!r}")
    chunks = set()
    open_type = None
    start = 0

    def emit(end):
        nonlocal open_type
        if open_type is not None and open_type not in excluded:
            chunks.add((open_type, start, end))
        open_type = None

    for i, t in enumerate(tags):
        t = int(t)
        if 0 <= t < num_chunk_types * n_tag:
            ct, tt = divmod(t, n_tag)
        else:
            ct = tt = None
        if open_type is not None:
            cont = ct == open_type and (
                scheme == "plain"
                or (scheme == "IOB" and tt == 1)          # I continues
                or scheme == "IOE"                         # I or E continue
                or (scheme == "IOBES" and tt in (1, 2)))   # I or E continue
            if not cont:
                emit(i - 1)
        if open_type is None and ct is not None:
            open_type, start = ct, i
        if open_type is not None and (
                (scheme == "IOE" and tt == 1)              # E closes
                or (scheme == "IOBES" and tt in (2, 3))):  # E or S closes
            emit(i)
    emit(len(tags) - 1)
    return chunks


def chunk_eval(input, label, chunk_scheme, num_chunk_types, length=None,
               excluded_chunk_types=None, name=None):
    """Chunking precision, recall and F1 (chunk_eval_op.h), counted on
    the host: ``(precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks)`` as Python numbers."""
    inf, lab = (_dispatch.host_array("chunk_eval", "the tags", t)
                for t in (input, label))
    if inf.ndim == 1:
        inf, lab = inf[None, :], lab[None, :]
    lens = _dispatch.host_array("chunk_eval", "the lengths", length) \
        if length is not None else \
        np.full((inf.shape[0],), inf.shape[1], np.int64)
    excluded = tuple(excluded_chunk_types or ())
    n_inf = n_lab = n_cor = 0
    for row_i, row_l, n in zip(inf, lab, lens):
        ci = _extract_chunks(row_i[:int(n)], chunk_scheme, num_chunk_types,
                             excluded)
        cl = _extract_chunks(row_l[:int(n)], chunk_scheme, num_chunk_types,
                             excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1, n_inf, n_lab, n_cor
