"""The op long tail (counterpart of ``paddle_tpu/ops/extras.py``): tensor
utilities, recommender-era feature ops, distillation and metric losses,
and small NN ops of the reference's catalog, each a fixed-shape torch
composition behind the funnel under the reference's op name.

The random ops (``uniform_random_batch_size_like``,
``gaussian_random_batch_size_like``, ``shuffle_batch``) draw through
``core.generator.draw`` from the port's seeded generator of the input's
device; a ``seed`` other than 0 draws from a generator of its own. The
JAX package's threefry draws differ. ``center_loss(update_center=True)``
also writes the new centers into ``centers`` in place, as the
reference's op (its ``CentersOut`` is ``Centers``). ``filter_by_instag``
reads its filter tags on the host, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core.dtypes import convert_dtype
from ..core.generator import draw
from ..core.tensor import Tensor, _raw
from . import dispatch as _dispatch
from .creation import _gen
from .dispatch import apply

__all__ = [
    "shape", "size", "assign_value",
    "fill_constant_batch_size_like", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "pad_constant_like",
    "squared_l2_distance", "bpr_loss", "modified_huber_loss",
    "teacher_student_sigmoid_loss", "center_loss", "mean_iou",
    "precision_recall", "positive_negative_pair", "affine_channel",
    "data_norm", "batch_fc", "partial_concat", "partial_sum",
    "shuffle_batch", "cvm", "filter_by_instag", "row_conv", "conv_shift",
    "add_position_encoding", "correlation", "similarity_focus", "fsp",
    "spp", "max_unpool2d", "match_matrix_tensor", "margin_rank_loss",
]


# -- tensor utilities ---------------------------------------------------------

def shape(input, name=None):
    """The shape as an int32 tensor (shape_op.cc)."""
    return apply("shape", lambda x: torch.tensor(
        tuple(x.shape), dtype=torch.int32, device=x.device), input)


def size(input, name=None):
    """The element count as an int64 scalar (size_op.cc)."""
    return apply("size", lambda x: torch.tensor(
        x.numel(), dtype=torch.int64, device=x.device), input)


def assign_value(shape, dtype, values, name=None):
    """A constant Tensor (assign_value_op.cc)."""
    from .creation import to_tensor
    return to_tensor(np.asarray(values, dtype).reshape(shape))


def _batch_shape(input, shape, input_dim_idx, output_dim_idx):
    shp = list(shape)
    shp[output_dim_idx] = int(_raw(input).shape[input_dim_idx])
    return shp


def _filled(x, shp, dtype, value):
    return torch.full(shp, value, dtype=dtype, device=x.device)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  name=None):
    """fill_constant_batch_size_like_op.cc."""
    return apply("fill_constant_batch_size_like", _filled, input,
                 shp=_batch_shape(input, shape, input_dim_idx,
                                  output_dim_idx),
                 dtype=convert_dtype(dtype), value=value)


def _uniform_like(x, shp, dtype, low, high, seed):
    g = _gen(x.device, seed)
    return draw(lambda: torch.empty(shp, dtype=dtype, device=x.device)
                .uniform_(low, high, generator=g))


def uniform_random_batch_size_like(input, shape, low=-1.0, high=1.0,
                                   input_dim_idx=0, output_dim_idx=0,
                                   dtype="float32", seed=0, name=None):
    """uniform_random_batch_size_like_op.cc."""
    return apply("uniform_random_batch_size_like", _uniform_like, input,
                 shp=_batch_shape(input, shape, input_dim_idx,
                                  output_dim_idx),
                 dtype=convert_dtype(dtype), low=float(low),
                 high=float(high), seed=seed)


def _gaussian_like(x, shp, dtype, mean, std, seed):
    g = _gen(x.device, seed)
    return mean + std * draw(lambda: torch.randn(
        shp, dtype=dtype, device=x.device, generator=g))


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    input_dim_idx=0, output_dim_idx=0,
                                    dtype="float32", seed=0, name=None):
    """gaussian_random_batch_size_like_op.cc."""
    return apply("gaussian_random_batch_size_like", _gaussian_like, input,
                 shp=_batch_shape(input, shape, input_dim_idx,
                                  output_dim_idx),
                 dtype=convert_dtype(dtype), mean=float(mean),
                 std=float(std), seed=seed)


def _pad_like(xx, yy, tgt, pad_value):
    pads = []
    for t, s in reversed(list(zip(tgt, yy.shape))):
        pads += [0, int(t) - int(s)]
    return tF.pad(yy, pads, value=pad_value)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """``y`` padded at the high end of every axis to ``x``'s shape
    (pad_constant_like_op.cc)."""
    return apply("pad_constant_like", _pad_like, x, y,
                 tgt=tuple(_raw(x).shape), pad_value=pad_value)


# -- losses -------------------------------------------------------------------

def _sq_l2(a, b):
    d = a.reshape(a.shape[0], -1) - b.reshape(b.shape[0], -1)
    return torch.sum(d * d, dim=1, keepdim=True)


def squared_l2_distance(x, y, name=None):
    """Row-wise ``||x - y||^2``, ``[N, 1]`` (squared_l2_distance_op.cc)."""
    return apply("squared_l2_distance", _sq_l2, x, y)


def _bpr(lg, lab):
    n, c = lg.shape
    pos = torch.gather(lg, 1, lab.reshape(n, 1).long())
    sp = tF.softplus(lg - pos)                        # j == y gives log 2
    mask = tF.one_hot(lab.reshape(n).long(), c).to(lg.dtype)
    return (torch.sum(sp * (1 - mask), dim=1, keepdim=True)
            / (c - 1)).to(lg.dtype)


def bpr_loss(input, label, name=None):
    """Bayesian personalised ranking (bpr_loss_op.h:70): the mean over
    ``j != y`` of ``softplus(x_j - x_y)``."""
    return apply("bpr_loss", _bpr, input, label)


def _mhuber(x, y):
    inter = x * (2.0 * y.to(x.dtype) - 1.0)
    return torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, (1.0 - inter) ** 2, 0.0))


def modified_huber_loss(input, label, name=None):
    """modified_huber_loss_op.h:43."""
    return apply("modified_huber_loss", _mhuber, input, label)


def _ts_sigmoid(x, lab, up, lo):
    x = x.reshape(-1)
    lab = lab.reshape(-1).to(x.dtype)

    def part(xx, t):
        return torch.clamp(xx, min=0) - xx * t + \
            torch.log1p(torch.exp(-torch.abs(xx)))
    xc = torch.clamp(x, lo, up)
    z = torch.where(lab < -1.0, 0.0, torch.where(
        lab < 0.0, 1.0, torch.where(lab < 1.0, 0.0, 1.0))).to(x.dtype)
    zprime = torch.where(lab < 1.0, lab, lab - 1.0)
    loss = part(x, z) + torch.where(lab >= 0.0, part(xc, zprime), 0.0)
    return loss.reshape(-1, 1)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0, name=None):
    """The CTR distillation loss (teacher_student_sigmoid_loss_op.h:34);
    ``label`` encodes the click and the teacher's score."""
    return apply("teacher_student_sigmoid_loss", _ts_sigmoid, input, label,
                 up=soft_max_up_bound, lo=soft_max_lower_bound)


def _center(x, lab, c, alpha, update):
    lab = lab.reshape(-1).long()
    diff = x - c[lab]                                  # [N, D]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if not update:
        return loss, c
    cnt = torch.zeros((c.shape[0],), dtype=x.dtype,
                      device=x.device).index_add(0, lab, torch.ones_like(
                          lab, dtype=x.dtype))
    upd = torch.zeros_like(c).index_add(0, lab, diff)
    return loss, c - alpha * upd / (1.0 + cnt)[:, None]


def center_loss(input, label, centers, alpha=0.1, update_center=True,
                name=None):
    """``0.5 ||x - c_y||^2`` per sample (center_loss_op.cc); returns
    ``(loss [N, 1], new_centers)``, where ``c_y -= alpha * sum(c_y - x_i)
    / (1 + count)``. With ``update_center`` the new centers are also
    written into ``centers`` in place."""
    loss, new_c = apply("center_loss", _center, input, label, centers,
                        alpha=alpha, update=update_center)
    if update_center and isinstance(centers, (Tensor, torch.Tensor)):
        with torch.no_grad():
            _raw(centers).copy_(_raw(new_c).detach())
    return loss, new_c


def _margin_rank(lab, left, right, margin):
    return torch.clamp(-lab * (left - right) + margin, min=0.0)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """``max(0, -label * (left - right) + margin)``
    (margin_rank_loss_op.cc, the fluid argument order)."""
    return apply("margin_rank_loss", _margin_rank, label, left, right,
                 margin=margin)


# -- metrics as ops -----------------------------------------------------------

def _count(idx, vals, C):
    return torch.zeros((C,), dtype=vals.dtype,
                       device=vals.device).index_add(0, idx, vals)


def _mean_iou(pred, lab, C):
    pred = pred.reshape(-1).long()
    lab = lab.reshape(-1).long()
    hit = (pred == lab).to(torch.int32)
    correct = _count(lab, hit, C)
    wrong = _count(pred, 1 - hit, C) + _count(lab, 1 - hit, C)
    denom = correct + wrong
    valid = denom > 0
    iou = torch.where(valid, correct / torch.clamp(denom, min=1), 0.0)
    miou = torch.sum(iou) / torch.clamp(valid.sum(), min=1)
    return miou.to(torch.float32), wrong, correct


def mean_iou(input, label, num_classes, name=None):
    """``(mean_iou, out_wrong [C], out_correct [C])`` (mean_iou_op.cc)."""
    return apply("mean_iou", _mean_iou, input, label, C=int(num_classes))


def _prec_rec(pred, lab, C):
    ids = torch.argmax(pred, dim=1) if pred.dim() == 2 else \
        pred.reshape(-1).long()
    lab = lab.reshape(-1).long()
    hit = (ids == lab).to(torch.float32)
    tp, fn, fp = _count(lab, hit, C), _count(lab, 1 - hit, C), \
        _count(ids, 1 - hit, C)

    def safe(n, d):
        return torch.where(d > 0, n / torch.clamp(d, min=1e-12), 0.0)
    prec, rec = safe(tp, tp + fp), safe(tp, tp + fn)
    f1 = safe(2 * prec * rec, prec + rec)
    present = (tp + fn + fp) > 0
    k = torch.clamp(present.sum(), min=1)
    TP, FP, FN = tp.sum(), fp.sum(), fn.sum()
    mp, mr = safe(TP, TP + FP), safe(TP, TP + FN)
    return torch.stack([torch.where(present, prec, 0).sum() / k,
                        torch.where(present, rec, 0).sum() / k,
                        torch.where(present, f1, 0).sum() / k,
                        mp, mr, safe(2 * mp * mr, mp + mr)])


def precision_recall(max_probs, label, num_classes, weights=None,
                     name=None):
    """``[macro P, R, F1, micro P, R, F1]`` (precision_recall_op.cc) from
    predicted ids or probability rows."""
    return apply("precision_recall", _prec_rec, max_probs, label,
                 C=int(num_classes))


def _pos_neg(s, lab, q):
    s, lab, q = s.reshape(-1), lab.reshape(-1), q.reshape(-1)
    valid = (q[:, None] == q[None, :]) & (lab[:, None] > lab[None, :])
    sd = s[:, None] - s[None, :]
    f = torch.float32
    return ((valid & (sd > 0)).sum().to(f), (valid & (sd < 0)).sum().to(f),
            (valid & (sd == 0)).sum().to(f))


def positive_negative_pair(score, label, query_id, name=None):
    """Per query, the ordered pairs a higher-labelled document scores
    above, below and level with (positive_negative_pair_op.cc)."""
    return apply("positive_negative_pair", _pos_neg, score, label, query_id)


# -- recommender feature ops --------------------------------------------------

def _affine_channel(xx, s, b, layout):
    shp = (1, -1) + (1,) * (xx.dim() - 2) if layout == "NCHW" else \
        (1,) * (xx.dim() - 1) + (-1,)
    return xx * s.reshape(shp) + b.reshape(shp)


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    """Per-channel ``x * scale + bias`` (affine_channel_op.cc)."""
    return apply("affine_channel", _affine_channel, x, scale, bias,
                 layout=data_layout)


def _data_norm(xx, bsz, bsum, bsq):
    means = bsum / bsz
    scales = torch.sqrt(bsz / bsq)
    return (xx - means[None, :]) * scales[None, :], means, scales


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4,
              name=None):
    """``(x - sum / size) * sqrt(size / square_sum)``, with the means and
    scales (data_norm_op.cc:302)."""
    return apply("data_norm", _data_norm, x, batch_size, batch_sum,
                 batch_square_sum)


def _batch_fc(x, w, *b):
    out = torch.einsum("snd,sdo->sno", x, w)
    return out + b[0] if b else out


def batch_fc(input, w, bias=None, name=None):
    """Per-slot FC: ``[S, N, D] x [S, D, O] (+ [S, 1, O])``
    (batch_fc_op.cc)."""
    args = (input, w) + ((bias,) if bias is not None else ())
    return apply("batch_fc", _batch_fc, *args)


def _col_slices(arrs, start, length):
    outs = []
    for a in arrs:
        st = start if start >= 0 else a.shape[1] + start
        n = a.shape[1] - st if length < 0 else length
        outs.append(a[:, st:st + n])
    return outs


def partial_concat(xs, start_index=0, length=-1, name=None):
    """The column slice ``[start, start + length)`` of each 2-D input,
    concatenated (partial_concat_op.cc)."""
    return apply("partial_concat", lambda arrs, start, length: torch.cat(
        _col_slices(arrs, start, length), dim=1), list(xs),
        start=start_index, length=length)


def _partial_sum(arrs, start, length):
    outs = _col_slices(arrs, start, length)
    return sum(outs[1:], outs[0])


def partial_sum(xs, start_index=0, length=-1, name=None):
    """The sum of the same column slice of each input
    (partial_sum_op.cc)."""
    return apply("partial_sum", _partial_sum, list(xs), start=start_index,
                 length=length)


def _shuffle(xx, seed):
    g = _gen(xx.device, seed)
    idx = draw(lambda: torch.randperm(xx.shape[0], generator=g,
                                      device=xx.device))
    return xx[idx], idx


def shuffle_batch(x, seed=0, name=None):
    """A random row permutation (shuffle_batch_op.cc); returns
    ``(shuffled, shuffle_idx)``."""
    return apply("shuffle_batch", _shuffle, x, seed=seed)


def _cvm(xx, use_cvm):
    if not use_cvm:
        return xx[:, 2:]
    show = torch.log(xx[:, :1] + 1.0)
    click = torch.log(xx[:, 1:2] + 1.0) - show
    return torch.cat([show, click, xx[:, 2:]], dim=1)


def cvm(x, use_cvm=True, name=None):
    """The CTR show/click transform (cvm_op.cc): columns 0/1 become
    ``log(show + 1)`` and ``log(click + 1) - log(show + 1)``, or are
    dropped."""
    return apply("cvm", _cvm, x, use_cvm=use_cvm)


def _instag(x, tags, ft, out_val):
    hit = torch.zeros((tags.shape[0],), dtype=torch.bool, device=x.device)
    for t in ft:
        hit = hit | torch.any(tags == t, dim=-1)
    out = torch.where(hit.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                      torch.full((), out_val, dtype=x.dtype,
                                 device=x.device))
    return out, hit, hit.to(x.dtype)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=False,
                     out_val_if_empty=0, name=None):
    """Keep the rows whose tags meet ``filter_tag``
    (filter_by_instag_op.cc) at the fixed shape: dropped rows become
    ``out_val_if_empty``; returns ``(out, mask, loss_weight)``. The
    filter tags are read on the host."""
    ft = filter_tag
    if isinstance(_raw(ft), torch.Tensor):
        ft = _dispatch.host_array("filter_by_instag", "the filter tags", ft)
    ft = np.asarray(ft).reshape(-1).tolist()
    return apply("filter_by_instag", _instag, ins, ins_tag, ft=ft,
                 out_val=out_val_if_empty)


# -- misc NN ops --------------------------------------------------------------

def _row_conv(xx, w):
    ctx, T = w.shape[0], xx.shape[1]
    pad = tF.pad(xx, (0, 0, 0, ctx - 1))
    out = torch.zeros_like(xx)
    for j in range(ctx):
        out = out + pad[:, j:j + T, :] * w[j][None, None, :]
    return out


def row_conv(x, weight, name=None):
    """Look-ahead row convolution (row_conv_op.cc): ``out_t = sum_j
    x_{t+j} * w_j``; ``x [B, T, D]``, ``weight [ctx, D]``."""
    return apply("row_conv", _row_conv, x, weight)


def _conv_shift(xx, yy):
    n, m = xx.shape[1], yy.shape[1]
    idx = (torch.arange(n, device=xx.device)[:, None]
           + torch.arange(m, device=xx.device)[None, :] - m // 2) % n
    return torch.einsum("bnm,bm->bn", xx[:, idx], yy)


def conv_shift(x, y, name=None):
    """Circular convolution (conv_shift_op.cc): ``out[b, i] = sum_j
    x[b, (i + j - M // 2) mod N] * y[b, j]``."""
    return apply("conv_shift", _conv_shift, x, y)


def _pos_enc(xx, alpha, beta):
    b, t, d = xx.shape
    half = d // 2
    pos = torch.arange(t, dtype=xx.dtype, device=xx.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, dtype=xx.dtype, device=xx.device),
                    torch.arange(half, dtype=xx.dtype,
                                 device=xx.device) / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    if d % 2:
        pe = tF.pad(pe, (0, 1))
    return alpha * xx + beta * pe[None]


def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    """``alpha * x + beta * PE`` with the sin half then the cos half
    (add_position_encoding_op.cc)."""
    return apply("add_position_encoding", _pos_enc, x, alpha=alpha,
                 beta=beta)


def _correlation(a, b, pad_size, max_displacement, stride1, stride2):
    N, C, H, W = a.shape
    d = max_displacement // stride2
    bp = tF.pad(b, (pad_size,) * 4)
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = pad_size + dy * stride2, pad_size + dx * stride2
            outs.append(torch.mean(a * bp[:, :, oy:oy + H, ox:ox + W],
                                   dim=1))
    out = torch.stack(outs, dim=1)                         # [N, D*D, H, W]
    return out[:, :, ::stride1, ::stride1] if stride1 > 1 else out


def correlation(x, y, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1, name=None):
    """The FlowNet cost volume (correlation_op.cc, kernel size 1): per
    displacement, the channel mean of ``x * shifted y``."""
    return apply("correlation", _correlation, x, y, pad_size=pad_size,
                 max_displacement=max_displacement, stride1=stride1,
                 stride2=stride2)


def _focus_one(t):
    """The greedy row- and column-exclusive argmax mask of ``t [N, B, C]``."""
    N, B, Cc = t.shape
    rows = torch.arange(N, device=t.device)
    mask = torch.zeros_like(t)
    for _ in range(min(B, Cc)):
        am = torch.argmax(t.reshape(N, -1), dim=1)
        i, j = am // Cc, am % Cc
        mask = mask.index_put((rows, i, j), torch.ones((), dtype=t.dtype,
                                                       device=t.device))
        used = torch.zeros((N, B), dtype=torch.bool, device=t.device)
        used = used.index_put((rows, i), torch.ones((), dtype=torch.bool,
                                                    device=t.device))
        cused = torch.zeros((N, Cc), dtype=torch.bool, device=t.device)
        cused = cused.index_put((rows, j), torch.ones((), dtype=torch.bool,
                                                      device=t.device))
        t = torch.where(used[:, :, None] | cused[:, None, :], -torch.inf, t)
    return mask


def _similarity_focus(xx, indexes):
    mask = torch.zeros((xx.shape[0],) + tuple(xx.shape[2:]), dtype=xx.dtype,
                       device=xx.device)
    for idx in indexes:
        mask = torch.maximum(mask, _focus_one(xx[:, idx]))
    return mask[:, None].expand(xx.shape)


def similarity_focus(x, axis, indexes, name=None):
    """The greedy row/column-exclusive argmax mask over ``x[:, idx]``
    (similarity_focus_op.cc), or-ed over ``indexes`` and broadcast to
    ``x``'s shape."""
    if axis != 1:
        raise ValueError("similarity_focus: reference supports axis=1")
    return apply("similarity_focus", _similarity_focus, x,
                 indexes=tuple(indexes))


def _fsp(a, b):
    return torch.einsum("bihw,bjhw->bij", a, b) / (a.shape[2] * a.shape[3])


def fsp(x, y, name=None):
    """The FSP matrix of distillation (fsp_op.cc)."""
    return apply("fsp", _fsp, x, y)


def _adaptive_pool(x, bins, kind):
    h, w = x.shape[2], x.shape[3]
    hs = [(i * h) // bins for i in range(bins)]
    he = [-(-((i + 1) * h) // bins) for i in range(bins)]
    ws = [(j * w) // bins for j in range(bins)]
    we = [-(-((j + 1) * w) // bins) for j in range(bins)]
    rows = []
    for i in range(bins):
        cols = []
        for j in range(bins):
            region = x[:, :, hs[i]:he[i], ws[j]:we[j]]
            cols.append(torch.amax(region, dim=(2, 3)) if kind == "max"
                        else region.mean(dim=(2, 3)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)                     # [N, C, bins, bins]


def _spp(xx, height, kind):
    return torch.cat([_adaptive_pool(xx, 2 ** level, kind).reshape(
        xx.shape[0], -1) for level in range(height)], dim=1)


def spp(x, pyramid_height, pool_type="max", name=None):
    """Spatial pyramid pooling (spp_op.cc): level ``l`` pools to a
    ``2^l x 2^l`` grid (an adaptive pool, as the JAX package's)."""
    return apply("spp", _spp, x, height=int(pyramid_height),
                 kind="max" if pool_type == "max" else "avg")


def _unpool(xx, idx, ks, st, padding, output_size):
    n, c, ph, pw = xx.shape
    if output_size is not None:
        oh, ow = output_size
    else:
        oh = (ph - 1) * st[0] + ks[0] - 2 * padding
        ow = (pw - 1) * st[1] + ks[1] - 2 * padding
    flat = torch.zeros((n, c, oh * ow), dtype=xx.dtype, device=xx.device)
    out = flat.scatter(2, idx.reshape(n, c, -1).long(), xx.reshape(n, c, -1))
    return out.reshape(n, c, oh, ow)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, name=None):
    """Pooled values back at the positions ``max_pool2d(return_mask=
    True)`` recorded (unpool_op.cc)."""
    ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = ks if stride is None else ((stride, stride) if isinstance(
        stride, int) else tuple(stride))
    return apply("max_unpool2d", _unpool, x, indices, ks=ks, st=st,
                 padding=padding, output_size=output_size)


def _match_matrix(xx, yy, ww, *lens):
    out = torch.einsum("bid,dte,bje->btij", xx, ww, yy)
    if lens:
        xl, yl = lens
        mi = torch.arange(xx.shape[1], device=xx.device)[None, :] < \
            xl[:, None]
        mj = torch.arange(yy.shape[1], device=yy.device)[None, :] < \
            yl[:, None]
        out = out * (mi[:, None, :, None] & mj[:, None, None, :])
    return out


def match_matrix_tensor(x, y, w, x_lengths=None, y_lengths=None, name=None):
    """The text-matching gram ``out[b, t, i, j] = x[b, i] . W[:, t] .
    y[b, j]`` over padded rows with lengths, padding masked to 0
    (match_matrix_tensor_op.cc)."""
    args = (x, y, w) + ((x_lengths, y_lengths)
                        if x_lengths is not None else ())
    return apply("match_matrix_tensor", _match_matrix, *args)
