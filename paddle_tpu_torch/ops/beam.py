"""Beam-search ops (counterpart of ``paddle_tpu/ops/beam.py``; reference:
beam_search_op.cc, beam_search_decode_op.cc, gather_tree_op.cc,
ctc_align_op.cc, edit_distance_op.cc).

A beam's lineage is an explicit ``[T, B, W]`` parents tensor, and
``gather_tree`` backtraces it in one reverse pass over ``T``: a Python
loop of ``take_along_dim`` over device tensors, which a CUDA graph
captures. ``beam_search`` takes its top ``W`` of the ``W * V``
candidates with the port's stable-sort top-k (``ops.math.topk``), so
that ties keep ``lax.top_k``'s order, the lower index first. Every op
here runs on the device with no host read.
"""
from __future__ import annotations

import torch

from .dispatch import apply
from .math import _topk

__all__ = ["gather_tree", "beam_search", "beam_search_decode", "ctc_align",
           "edit_distance"]


def _gather_tree(ids, parents):
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], dtype=ids.dtype,
                        device=ids.device).expand(ids.shape[1:])
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.take_along_dim(ids[t], beam.long(), dim=1)
        beam = torch.take_along_dim(parents[t], beam.long(),
                                    dim=1).to(ids.dtype)
    return torch.stack(toks)


def gather_tree(ids, parents):
    """Backtrace beam lineage (gather_tree_op.cc). ``ids``/``parents``
    ``[T, B, W]``, step-major; column ``w`` of the result holds the tokens
    along the ancestry of final beam ``w``."""
    return apply("gather_tree", _gather_tree, ids, parents)


def _beam_search(p_ids, p_sc, sc, W, end_id, is_accumulated):
    B, Wv, V = sc.shape
    total = sc if is_accumulated else p_sc[..., None] + sc
    # a finished beam contributes one candidate: itself, at its score
    only_end = torch.full((B, Wv, V), -torch.inf, dtype=total.dtype,
                          device=total.device)
    only_end[:, :, end_id] = p_sc.to(total.dtype)
    cand = torch.where((p_ids == end_id)[..., None], only_end, total)
    top_sc, top_ix = _topk(cand.reshape(B, Wv * V), W, -1, True)
    return (top_ix % V).to(p_ids.dtype), top_sc, top_ix // V


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, return_parent_idx=True):
    """One expansion step (beam_search_op.cc): ``pre_ids``/``pre_scores``
    ``[B, W]``, ``scores [B, W, V]`` (accumulated when
    ``is_accumulated``). Returns ``(selected_ids, selected_scores,
    parent_idx)``, each ``[B, W]``; a finished beam (``pre_id ==
    end_id``) propagates only itself."""
    return apply("beam_search", _beam_search, pre_ids, pre_scores, scores,
                 W=int(beam_size), end_id=int(end_id),
                 is_accumulated=is_accumulated)


def beam_search_decode(ids, parents, scores, beam_size=None, end_id=0):
    """Backtrace every step into the final sequences
    (beam_search_decode_op.cc): ``(gather_tree(ids, parents), scores)``."""
    return gather_tree(ids, parents), scores


def _ctc_align(ids, *rest, blank, merge_repeated, padding_value):
    B, T = ids.shape
    lens = rest[0] if rest else None
    t = torch.arange(T, device=ids.device)[None, :]
    valid = t < lens[:, None] if lens is not None else \
        torch.ones((B, T), dtype=torch.bool, device=ids.device)
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank)
    if merge_repeated:
        keep = keep & (ids != prev)
    # kept tokens to their packed slots, the rest to a column dropped after
    dest = torch.where(keep, torch.cumsum(keep.long(), dim=1) - 1, T)
    out = torch.full((B, T + 1), padding_value, dtype=ids.dtype,
                     device=ids.device).scatter(1, dest, ids)
    return out[:, :T], keep.sum(dim=1)


def ctc_align(input, blank=0, merge_repeated=True, padding_value=0,
              lengths=None, name=None):
    """Collapse repeats, then drop blanks, packing to the left
    (ctc_align_op.cc). Returns ``(aligned [B, T], lengths [B])``."""
    args = (input,) + ((lengths,) if lengths is not None else ())
    return apply("ctc_align", _ctc_align, *args, blank=blank,
                 merge_repeated=merge_repeated, padding_value=padding_value)


def _edit_distance(hyp, ref, *rest, has_hlen, has_rlen, normalized):
    it = iter(rest)
    B, Th = hyp.shape
    Tr = ref.shape[1]
    dev = hyp.device
    hlen = next(it).long() if has_hlen else torch.full((B,), Th, device=dev)
    rlen = next(it).long() if has_rlen else torch.full((B,), Tr, device=dev)
    # row j holds the distances of ref[:j] to every prefix of hyp
    row = torch.arange(Th + 1, device=dev).expand(B, Th + 1)
    for j in range(Tr):
        live = j < rlen
        col = torch.where(live, torch.full((B,), j + 1, device=dev),
                          row[:, 0])
        cols = [col]
        for i in range(Th):
            sub = row[:, i] + (hyp[:, i] != ref[:, j]).long()
            best = torch.minimum(torch.minimum(sub, cols[-1] + 1),
                                 row[:, i + 1] + 1)
            cols.append(torch.where(live, best, row[:, i + 1]))
        row = torch.stack(cols, dim=1)
    d = torch.take_along_dim(row, hlen[:, None], dim=1)[:, 0].float()
    if normalized:
        d = d / torch.clamp(rlen.float(), min=1.0)
    return d[:, None], torch.full((1,), B, dtype=torch.int64, device=dev)


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance per row over padded ids and lengths
    (edit_distance_op.cc). Returns ``(dist [B, 1], seq_num [1])``."""
    args = [input, label] + \
        ([input_length] if input_length is not None else []) + \
        ([label_length] if label_length is not None else [])
    return apply("edit_distance", _edit_distance, *args,
                 has_hlen=input_length is not None,
                 has_rlen=label_length is not None, normalized=normalized)
