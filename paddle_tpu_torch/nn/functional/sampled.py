"""Sampled and tree-structured classification heads (counterpart of
``paddle_tpu/nn/functional/sampled.py``; reference: nce_op.h:80,
hierarchical_sigmoid_op.h, class_center_sample_op.cu,
sample_logits_op.cc, sampling_id_op.cc).

Every draw goes through ``core.generator.draw`` from the port's seeded
generator of the input's device (a ``seed`` other than 0: a generator of
its own), so the same ``paddle.seed`` gives the same draws; the JAX
package's threefry draws differ. Given the draws, the arithmetic is the
JAX package's: log-uniform classes are ``floor(exp(u log(r + 1))) - 1``
clipped to ``[0, r - 1]``, Gumbel noise is ``-log(-log(u))``, and every
top-k is the port's stable-sort one (the lower index first on ties). The
shapes are fixed, so a head runs inside a captured program;
``class_center_sample`` checks its positives on the host outside a
capture only, as the JAX package checks them outside a trace.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ...core.generator import draw
from ...core.tensor import _raw
from ...ops import dispatch as _dispatch
from ...ops.creation import _gen
from ...ops.dispatch import apply
from ...ops.math import _topk

__all__ = ["hsigmoid_loss", "hierarchical_sigmoid", "nce",
           "class_center_sample", "sampling_id", "sample_logits"]


# -- hierarchical sigmoid -----------------------------------------------------

def _bce_sum(x, w, idx, t, valid, b):
    pre = torch.einsum("nd,nld->nl", x, w[idx])                 # [N, L]
    if b is not None:
        pre = pre + b.reshape(-1)[idx]
    pre = torch.clamp(pre, -40.0, 40.0)
    loss = tF.softplus(pre) - t * pre
    return torch.sum(torch.where(valid, loss, 0), dim=1, keepdim=True)


def _hsig_default(x, lab, w, *maybe_b, C, max_len):
    code = lab.reshape(-1).long() + C
    bits = torch.arange(max_len, device=x.device)
    up = code[:, None] >> (bits[None, :] + 1)
    # bit b is an edge of the path while the code has set bits above b
    valid = up > 0
    idx = torch.where(valid, up - 1, 0)
    t = ((code[:, None] >> bits[None, :]) & 1).to(x.dtype)
    return _bce_sum(x, w, idx, t, valid, maybe_b[0] if maybe_b else None)


def _hsig_custom(x, lab, w, pt, pc, *maybe_b):
    pt = pt.long()
    valid = pt >= 0
    return _bce_sum(x, w, torch.where(valid, pt, 0), pc.to(x.dtype), valid,
                    maybe_b[0] if maybe_b else None)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The hierarchical sigmoid loss ``[N, 1]``
    (hierarchical_sigmoid_op.cc, matrix_bit_code.h SimpleCode: ``code =
    label + num_classes``). Without ``path_table`` the complete binary
    tree; else the custom tree of ``path_table [N, L]`` (node ids, -1
    padding) and ``path_code [N, L]`` (0/1 bits)."""
    C = int(num_classes)
    tail = (bias,) if bias is not None else ()
    if path_table is None:
        max_len = max(int(np.ceil(np.log2(max(C, 2)))) + 1, 1)
        return apply("hsigmoid_loss", _hsig_default, input, label, weight,
                     *tail, C=C, max_len=max_len)
    return apply("hsigmoid_loss", _hsig_custom, input, label, weight,
                 path_table, path_code, *tail)


def hierarchical_sigmoid(input, label, num_classes, weight, bias=None,
                         path_table=None, path_code=None, is_sparse=False,
                         name=None):
    """The fluid-era name of :func:`hsigmoid_loss`."""
    return hsigmoid_loss(input, label, num_classes, weight, bias,
                         path_table, path_code, is_sparse)


# -- NCE ----------------------------------------------------------------------

def _log_uniform_prob(c, range_max):
    """P(c) under LogUniformSampler(range_max): support ``[0,
    range_max - 1]``, normalised by ``log(range_max + 1)``."""
    cf = c.to(torch.float32)
    return torch.log((cf + 2.0) / (cf + 1.0)) / math.log(range_max + 1.0)


def _sample_classes(g, shape, num_classes, sampler, device, range_max=None):
    """``(classes, probabilities)`` of ``shape`` drawn from ``g``."""
    if sampler == "uniform":
        s = draw(lambda: torch.randint(0, num_classes, shape, generator=g,
                                       device=device))
        return s, torch.full(shape, 1.0 / num_classes, device=device)
    if sampler == "log_uniform":
        r = num_classes if range_max is None else range_max
        u = draw(lambda: torch.rand(shape, generator=g, device=device))
        s = torch.clamp(torch.exp(u * math.log(r + 1.0)).long() - 1, 0,
                        r - 1)
        return s, _log_uniform_prob(s, r)
    raise ValueError(f"nce: unknown sampler {sampler!r} "
                     "(uniform | log_uniform | custom_dist)")


def _nce(x, lab, w, *rest, has_bias, has_sw, C, k, sampler, probs, seed):
    rest = list(rest)
    b_vec = rest.pop(0) if has_bias else None
    sw = rest.pop(0) if has_sw else None
    dev = x.device
    g = _gen(dev, seed)
    lab = lab.reshape(x.shape[0], -1).long()                   # [N, T]
    if sampler == "custom_dist":
        probs = probs.to(dev)
        neg = draw(lambda: torch.multinomial(
            probs[None, :].expand(x.shape[0], -1), k, replacement=True,
            generator=g))
    else:
        # nce_op.h builds LogUniformSampler(num_total_classes - 1)
        neg, _ = _sample_classes(g, (x.shape[0], k), C, sampler, dev,
                                 range_max=C - 1)
    classes = torch.cat([lab, neg], dim=1)                     # [N, T+k]
    if sampler == "custom_dist":
        p = probs[classes]
    elif sampler == "uniform":
        p = torch.full(classes.shape, 1.0 / C, device=dev)
    else:
        p = _log_uniform_prob(classes, C - 1)
    logits = torch.einsum("nd,nsd->ns", x, w[classes])
    if b_vec is not None:
        logits = logits + b_vec.reshape(-1)[classes]
    o = torch.sigmoid(logits)
    bq = (p * k).to(o.dtype)
    is_true = torch.arange(classes.shape[1], device=dev) < lab.shape[1]
    cost = torch.where(is_true[None, :], -torch.log(o / (o + bq) + 1e-12),
                       -torch.log(bq / (o + bq) + 1e-12))
    out = torch.sum(cost, dim=1, keepdim=True)
    return out * sw.reshape(-1, 1) if sw is not None else out


def nce(input, label, weight, bias=None, num_neg_samples=10,
        num_total_classes=None, sampler="uniform", custom_dist=None,
        seed=0, sample_weight=None, name=None):
    """Noise-contrastive estimation (nce_op.h:80): per row,
    ``num_neg_samples`` negative classes and ``o = sigmoid(x . w_c +
    b_c)``; ``cost = sum_true -log(o / (o + b)) + sum_neg -log(b / (o +
    b))`` with ``b = P(class) * num_neg_samples``. Returns ``[N, 1]``."""
    C = int(num_total_classes if num_total_classes is not None
            else _raw(weight).shape[0])
    probs = torch.from_numpy(np.asarray(custom_dist, np.float32)) \
        if sampler == "custom_dist" else None
    args = [input, label, weight] + ([bias] if bias is not None else []) \
        + ([sample_weight] if sample_weight is not None else [])
    return apply("nce", _nce, *args, has_bias=bias is not None,
                 has_sw=sample_weight is not None, C=C,
                 k=int(num_neg_samples), sampler=sampler, probs=probs,
                 seed=seed)


# -- class_center_sample ------------------------------------------------------

def _class_centers(lab, C, S):
    lab = lab.reshape(-1).long()
    pos = torch.zeros((C,), dtype=torch.bool, device=lab.device)
    pos[lab] = True
    g = _gen(lab.device)
    u = draw(lambda: torch.rand((C,), generator=g, device=lab.device))
    order = torch.argsort(torch.where(pos, -1.0, u), stable=True)
    sampled = torch.sort(order[:S]).values
    remap = torch.zeros((C,), dtype=torch.long, device=lab.device)
    remap[sampled] = torch.arange(S, device=lab.device)
    return remap[lab], sampled


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """PartialFC sampling (class_center_sample_op.cu): every positive
    class center, padded with uniformly drawn negatives to
    ``num_samples``; returns ``(remapped_label [N],
    sampled_class_center [num_samples])``, the centers ascending."""
    if group not in (None, False):
        raise NotImplementedError(
            "class_center_sample(group=...) samples across a model-parallel "
            "group, which is the second slice of ROADMAP queue A10; pass "
            "group=None")
    C, S = int(num_classes), int(num_samples)
    if S > C:
        raise ValueError(f"class_center_sample: num_samples={S} > "
                         f"num_classes={C}")
    if not _dispatch.capturing():
        npos = int(torch.unique(_raw(label)).numel())
        if npos > S:
            raise ValueError(
                f"class_center_sample: batch holds {npos} distinct positive "
                f"classes but num_samples={S}; every positive center must "
                f"fit (reference enforces the same)")
    return apply("class_center_sample", _class_centers, label, C=C, S=S)


# -- sampling_id / sample_logits ---------------------------------------------

def _sampling_id(p, seed):
    g = _gen(p.device, seed)
    return draw(lambda: torch.multinomial(
        torch.clamp(p, min=1e-30), 1, generator=g))[:, 0]


def sampling_id(x, min=0, max=None, seed=0, dtype="int64", name=None):
    """One categorical draw per row of a probability matrix ``[N, C]``
    (sampling_id_op.cc)."""
    return apply("sampling_id", _sampling_id, x, seed=seed)


def _gumbel(g, shape, device):
    u = draw(lambda: torch.rand(shape, generator=g, device=device))
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _sample_logits(lg, lab, S, uniq, remove_hits, seed):
    n, C = lg.shape
    dev = lg.device
    g = _gen(dev, seed)
    lab = lab.reshape(n, -1).long()                             # [N, T]
    T = lab.shape[1]
    if uniq:
        # Gumbel top-k: weighted sampling without replacement
        logp = torch.log(_log_uniform_prob(torch.arange(C, device=dev), C))
        _, neg = _topk(logp[None, :] + _gumbel(g, (n, C), dev), S, -1, True)
    else:
        neg, _ = _sample_classes(g, (n, S), C, "log_uniform", dev)
    classes = torch.cat([lab, neg], dim=1)                      # [N, T+S]
    p = _log_uniform_prob(classes, C)
    q = -torch.expm1(S * torch.log1p(-p)) if uniq else p
    s_logits = torch.gather(lg, 1, classes) - torch.log(q)
    if remove_hits:
        hit = (neg[:, :, None] == lab[:, None, :]).any(-1)      # [N, S]
        s_logits = torch.cat([s_logits[:, :T], torch.where(
            hit, torch.full((), -1e20, dtype=s_logits.dtype, device=dev),
            s_logits[:, T:])], dim=1)
    return s_logits, torch.arange(T, device=dev).expand(n, T).clone()


def sample_logits(logits, label, num_samples, uniq=True,
                  remove_accidental_hits=True, seed=0, name=None):
    """Sampled-softmax preparation (sample_logits_op.cc): the true classes
    then ``num_samples`` log-uniform negatives, their logits less
    ``log q(class)``, accidental hits at -1e20. ``uniq`` draws the
    negatives without replacement (Gumbel top-k; ``q = 1 - (1 - p)^S``).
    Returns ``(sampled_logits [N, T + S], sampled_label [N, T])``."""
    return apply("sample_logits", _sample_logits, logits, label,
                 S=int(num_samples), uniq=uniq,
                 remove_hits=remove_accidental_hits, seed=seed)
