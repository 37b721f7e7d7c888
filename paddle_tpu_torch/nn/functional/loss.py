"""Classification losses (counterpart of ``paddle_tpu/nn/functional/loss.py``:
``cross_entropy``, ``softmax_with_cross_entropy`` and ``nll_loss``).

The formulas are the JAX package's: hard labels may carry a trailing
size-1 class axis and arrive as any integer type (int32 included);
entries equal to ``ignore_index`` add nothing; ``mean`` divides by the
number of labels that are not ignored (at least 1), or by the sum of
their class weights when ``weight`` is given. Under AMP both are
black-listed ops (``softmax_with_cross_entropy``, ``nll_loss``): a
low-type input comes back to float32.
"""
from __future__ import annotations

import torch

from ... import amp
from .activation import softmax


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "none":
        return out
    raise ValueError(f"reduction {reduction!r} not in ('mean', 'sum', "
                     "'none')")


def _pick(logp, label, axis, ignore_index):
    """``(-logp at the label, valid mask, label with ignored entries
    replaced by 0)`` for hard labels along ``axis``."""
    lab = label.long()
    if lab.dim() == logp.dim():                   # [N, ..., 1] hard labels
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    return -picked, valid, safe


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy over ``axis`` (``use_softmax=False`` takes
    ``input`` as probabilities). ``soft_label`` takes ``label`` as a
    distribution over the classes."""
    input, label, weight = amp.cast_inputs("softmax_with_cross_entropy",
                                           input, label, weight)
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(input.clamp_min(1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    loss, valid, safe = _pick(logp, label, axis, ignore_index)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe],
                                torch.zeros_like(loss)).sum()
        else:
            denom = valid.sum().to(loss.dtype).clamp_min(1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-entry loss with the class axis kept (size 1), optionally
    with the softmax."""
    out = cross_entropy(logits, label, soft_label=soft_label,
                        ignore_index=ignore_index, reduction="none",
                        axis=axis)
    # the reference's unsqueeze is an op of its own ("unsqueeze2"), which
    # O2 casts to the low type
    (out,) = amp.cast_inputs("unsqueeze2", out)
    out = out.unsqueeze(axis)
    if return_softmax:
        return out, softmax(logits, axis=axis)
    return out


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log likelihood of ``input`` (log-probabilities, classes on
    axis 1)."""
    input, label, weight = amp.cast_inputs("nll_loss", input, label, weight)
    loss, valid, safe = _pick(input, label, 1, ignore_index)
    cw = weight[safe] if weight is not None else torch.ones_like(loss)
    loss = torch.where(valid, loss * cw, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / torch.where(valid, cw, torch.zeros_like(cw)) \
            .sum().clamp_min(1e-12)
    return _reduce(loss, reduction)
