"""Losses (counterpart of ``paddle_tpu/nn/functional/loss.py``, all of
it): the classification losses ``cross_entropy``,
``softmax_with_cross_entropy`` and ``nll_loss``, then the regression,
binary, ranking, embedding and sequence losses with ``label_smooth``,
``cosine_similarity``, ``ctc_loss``/``warpctc`` and
``ctc_greedy_decoder``, each under the reference's op name and formula.
``ctc_loss`` applies ``log_softmax`` to its input and marks impossible
paths with -1e30, not -inf, so such a loss is finite (torch's
``F.ctc_loss`` gives inf).

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

from ...core.tensor import Tensor
from ...ops.dispatch import apply
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
    distribution over the classes; op ``softmax_with_cross_entropy``."""
    return apply("softmax_with_cross_entropy", _cross_entropy, input, label,
                 weight, ignore_index=ignore_index, reduction=reduction,
                 soft_label=soft_label, axis=axis, use_softmax=use_softmax)


def _cross_entropy(input, label, weight, ignore_index, reduction,
                   soft_label, axis, use_softmax):
    if type(input) is not torch.Tensor and type(label) is torch.Tensor:
        from ...distributed.mesh import is_dtensor, like
        if is_dtensor(input):
            # logits on a mesh: the labels (the global batch's) follow
            label = like(label, input)
    mesh_dim = _class_sharded(input, axis) if use_softmax and \
        not soft_label and weight is None else None
    if mesh_dim is not None:
        # classes sharded over a mesh axis: the parallel cross entropy,
        # where a log_softmax would gather every rank's logits
        from ...distributed.mesh import vocab_parallel_nll
        lab = label.long()
        if lab.dim() == input.dim():
            lab = lab.squeeze(axis)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        loss = vocab_parallel_nll(input, safe, mesh_dim)
        return _finish_nll(loss, valid, safe, weight, reduction)
    logp = torch.log_softmax(input, dim=axis) if use_softmax \
        else torch.log(input.clamp_min(1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    loss, valid, safe = _pick(logp, label, axis, ignore_index)
    return _finish_nll(loss, valid, safe, weight, reduction)


def _class_sharded(input, axis):
    if type(input) is torch.Tensor:
        return None
    from ...distributed.mesh import class_sharded_axis
    return class_sharded_axis(input, axis)


def _finish_nll(loss, valid, safe, weight, reduction):
    """The per-entry ``loss`` weighted, ignored entries zeroed, reduced."""
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
    out = apply("unsqueeze2", torch.unsqueeze, out, axis)
    if return_softmax:
        return out, softmax(logits, axis=axis)
    return out


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log likelihood of ``input`` (log-probabilities, classes on
    axis 1); op ``nll_loss``."""
    return apply("nll_loss", _nll_loss, input, label, weight,
                 ignore_index=ignore_index, reduction=reduction)


def _nll_loss(input, label, weight, ignore_index, reduction):
    loss, valid, safe = _pick(input, label, 1, ignore_index)
    cw = weight[safe] if weight is not None else torch.ones_like(loss)
    loss = torch.where(valid, loss * cw, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / torch.where(valid, cw, torch.zeros_like(cw)) \
            .sum().clamp_min(1e-12)
    return _reduce(loss, reduction)


def _mse_loss(a, b, reduction):
    return _reduce((a - b) ** 2, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return apply("mse_loss", _mse_loss, input, label, reduction=reduction)


def _l1_loss(a, b, reduction):
    return _reduce(torch.abs(a - b), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return apply("l1_loss", _l1_loss, input, label, reduction=reduction)


def _square_error_cost(a, b):
    return (a - b) ** 2


def square_error_cost(input, label):
    return apply("square_error_cost", _square_error_cost, input, label)


def _bce(p, y, w, reduction):
    p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return _reduce(loss * w if w is not None else loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return apply("bce_loss", _bce, input, label, weight,
                 reduction=reduction)


def _softplus_neg_abs(z):
    """``log(1 + exp(-|z|))``, as ``logaddexp(0, -|z|)``."""
    return torch.logaddexp(torch.zeros_like(z), -torch.abs(z))


def _bce_logits(z, y, w, pw, reduction):
    if pw is not None:
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (_softplus_neg_abs(z)
                                      + torch.clamp_min(-z, 0.0))
    else:
        loss = torch.clamp_min(z, 0.0) - z * y + _softplus_neg_abs(z)
    return _reduce(loss * w if w is not None else loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(z, 0) - z·y + log(1 + exp(-|z|))`` (with
    ``pos_weight``'s variant); op ``sigmoid_cross_entropy_with_logits``."""
    return apply("sigmoid_cross_entropy_with_logits", _bce_logits, logit,
                 label, weight, pos_weight, reduction=reduction)


def _focal(z, y, norm, alpha, gamma, reduction):
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0.0) - z * y + _softplus_neg_abs(z)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    return _reduce(loss / norm if norm is not None else loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return apply("sigmoid_focal_loss", _focal, logit, label, normalizer,
                 alpha=alpha, gamma=gamma, reduction=reduction)


def _kl_div(logp, y, reduction):
    loss = torch.where(y > 0, y * (torch.log(torch.clamp_min(y, 1e-30))
                                   - logp), torch.zeros_like(logp))
    if reduction == "batchmean":
        return torch.sum(loss) / logp.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """KL divergence of ``label`` from the log-probabilities ``input``
    (reference: operators/kldiv_loss_op.cc)."""
    return apply("kldiv_loss", _kl_div, input, label, reduction=reduction)


def _smooth_l1(a, b, reduction, delta):
    d = torch.abs(a - b)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return apply("smooth_l1_loss", _smooth_l1, input, label,
                 reduction=reduction, delta=delta)


def _huber(a, b, delta):
    d = torch.abs(a - b)
    return torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def huber_loss(input, label, delta=1.0):
    return apply("huber_loss", _huber, input, label, delta=delta)


def _hinge(a, y):
    return torch.clamp_min(1.0 - (2.0 * y - 1.0) * a, 0.0)


def hinge_loss(input, label):
    return apply("hinge_loss", _hinge, input, label)


def _log_loss(p, y, epsilon):
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply("log_loss", _log_loss, input, label, epsilon=epsilon)


def _margin_rank(a, b, y, margin, reduction):
    return _reduce(torch.clamp_min(-y * (a - b) + margin, 0.0), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply("margin_rank_loss", _margin_rank, input, other, label,
                 margin=margin, reduction=reduction)


def _cosine_similarity(a, b, axis, eps):
    num = torch.sum(a * b, dim=axis)
    den = torch.sqrt(torch.sum(a * a, dim=axis)) * torch.sqrt(
        torch.sum(b * b, dim=axis))
    return num / torch.clamp_min(den, eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply("cos_sim", _cosine_similarity, x1, x2, axis=axis, eps=eps)


def _cosine_embedding(a, b, y, margin, reduction):
    cos = torch.sum(a * b, dim=1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=1)
        * torch.linalg.vector_norm(b, dim=1), 1e-12)
    return _reduce(torch.where(y == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return apply("cosine_embedding_loss", _cosine_embedding, input1, input2,
                 label, margin=margin, reduction=reduction)


def _triplet(a, pos, neg, margin, p, epsilon, swap, reduction):
    def dist(u, v):
        return torch.pow(torch.sum(torch.pow(torch.abs(u - v), p), -1)
                         + epsilon, 1 / p)
    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return apply("triplet_margin_loss", _triplet, input, positive, negative,
                 margin=margin, p=p, epsilon=epsilon, swap=swap,
                 reduction=reduction)


def _label_smooth(y, pd, epsilon):
    if pd is not None:
        return (1 - epsilon) * y + epsilon * pd
    return (1 - epsilon) * y + epsilon / y.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return apply("label_smooth", _label_smooth, label, prior_dist,
                 epsilon=epsilon)


#: the log-probability of an impossible path (finite, as the reference's)
_CTC_NEG = -1e30


def _ctc(lp, lab, in_len, lab_len, blank, reduction, norm_by_times):
    n, s = lp.shape[1], lab.shape[1]
    ext = torch.full((n, 2 * s + 1), blank, dtype=torch.long,
                     device=lp.device)
    ext[:, 1::2] = lab.long()
    ext_len = 2 * lab_len.long() + 1
    lp = torch.log_softmax(lp, dim=-1)
    neg = torch.full((), _CTC_NEG, dtype=lp.dtype, device=lp.device)

    def emit(t):
        return torch.gather(lp[t], 1, ext)

    e0 = emit(0)
    alpha = torch.cat([e0[:, :1], torch.where(ext_len > 1, e0[:, 1], neg)
                       [:, None], neg.expand(n, 2 * s - 1)], 1)
    same = torch.cat([torch.zeros((n, 2), dtype=torch.bool,
                                  device=lp.device),
                      ext[:, 2:] == ext[:, :-2]], 1)
    for t in range(1, lp.shape[0]):
        shift1 = torch.cat([neg.expand(n, 1), alpha[:, :-1]], 1)
        shift2 = torch.where(same, neg, torch.cat(
            [neg.expand(n, 2), alpha[:, :-2]], 1))
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) +             emit(t)
        alpha = torch.where((t >= in_len)[:, None], alpha, new)
    last = (ext_len - 1)[:, None]
    loss = -torch.logaddexp(torch.gather(alpha, 1, last)[:, 0],
                            torch.gather(alpha, 1, (last - 1).clamp_min(0))
                            [:, 0])
    if norm_by_times:
        loss = loss / in_len.to(loss.dtype)
    if reduction == "mean":
        return torch.mean(loss / lab_len.to(loss.dtype))
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward recursion in log space (reference: warpctc
    op): ``log_probs`` ``[T, N, C]`` (``log_softmax`` is applied inside),
    ``labels`` ``[N, S]``; ``mean`` averages the losses over the label
    lengths."""
    return apply("warpctc", _ctc, log_probs, labels, input_lengths,
                 label_lengths, blank=blank, reduction=reduction,
                 norm_by_times=norm_by_times)


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """The fluid-era ``ctc_loss`` (per-sequence losses; the lengths
    default to the padded extents)."""
    t_len, n = input.shape[0], input.shape[1]
    dev = (input._data if isinstance(input, Tensor) else input).device
    if input_length is None:
        input_length = Tensor(torch.full((n,), t_len, dtype=torch.int64,
                                         device=dev))
    if label_length is None:
        label_length = Tensor(torch.full((n,), label.shape[1],
                                         dtype=torch.int64, device=dev))
    return ctc_loss(input, label, input_length, label_length, blank=blank,
                    reduction="none", norm_by_times=norm_by_times)


def _hinge_embedding(x, y, margin, reduction):
    return _reduce(torch.where(y > 0, x, torch.clamp_min(margin - x, 0.0)),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply("hinge_embedding_loss", _hinge_embedding, input, label,
                 margin=margin, reduction=reduction)


def _rank_loss(lab, left, right):
    o = left - right
    return torch.log1p(torch.exp(-torch.abs(o))) + torch.clamp_min(o, 0.0) \
        - o * lab


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss ``log(1 + exp(o)) - o·label``, ``o = left -
    right`` (reference: operators/rank_loss_op.cc)."""
    return apply("rank_loss", _rank_loss, label, left, right)


def _dice(x, y, epsilon):
    oh = (y.squeeze(-1).long().unsqueeze(-1) == torch.arange(
        x.shape[-1], device=x.device)).to(x.dtype)
    xf, yf = x.reshape(x.shape[0], -1), oh.reshape(x.shape[0], -1)
    inter = torch.sum(xf * yf, dim=1)
    union = torch.sum(xf, dim=1) + torch.sum(yf, dim=1)
    return torch.mean(1.0 - (2.0 * inter) / (union + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - 2|X∩Y| / (|X| + |Y| + epsilon)`` averaged over the batch;
    ``input`` ``[N, ..., C]`` probabilities, ``label`` ``[N, ..., 1]``
    ids."""
    return apply("dice_loss", _dice, input, label, epsilon=epsilon)


def _ctc_argmax(lp, batch_major):
    ids = torch.argmax(lp, dim=-1)
    return ids if batch_major else ids.t()


def _ctc_align(ids, *lens, blank, padding_value):
    b, t = ids.shape
    pos = torch.arange(t, device=ids.device)[None, :]
    valid = pos < lens[0][:, None] if lens else torch.ones_like(
        ids, dtype=torch.bool)
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], 1)
    keep = valid & (ids != blank) & (ids != prev)
    dest = torch.where(keep, torch.cumsum(keep.long(), 1) - 1,
                       torch.full_like(ids, t))    # dropped: a spare column
    out = torch.full((b, t + 1), padding_value, dtype=ids.dtype,
                     device=ids.device).scatter(1, dest, ids)
    return out[:, :t], keep.sum(1)


def ctc_greedy_decoder(input, blank=None, input_length=None,
                       padding_value=0):
    """Argmax per step, then repeats merged and blanks dropped, the
    survivors left-packed (reference: ctc_align_op.cc): ``input`` is
    ``[T, N, C]``, or ``[N, T, C]`` with ``input_length``; returns
    ``(decoded [N, T], lengths)``."""
    ids = apply("ctc_argmax", _ctc_argmax, input,
                batch_major=input_length is not None)
    lens = () if input_length is None else (input_length,)
    return apply("ctc_align", _ctc_align, ids, *lens,
                 blank=0 if blank is None else blank,
                 padding_value=padding_value)
