"""Detection ops of the YOLOv3 serving and training paths (counterpart
of ``paddle_tpu/ops/detection.py:44-212`` and ``:316-430``):
``yolo_box``, ``iou_similarity``, ``box_clip``, ``multiclass_nms`` and
``yolov3_loss``.

Outputs keep the JAX package's fixed sizes: ``multiclass_nms`` returns
exactly ``keep_top_k`` rows per image, padded rows carry label -1, and
an int32 count per image says how many rows are real.

``multiclass_nms`` takes the top ``nms_top_k`` candidates of every
(image, class) pair, builds their IoU matrices on the device and runs
the greedy scan for all pairs at once through
:func:`paddle_tpu_torch.ops.custom.greedy_nms`: the CUDA kernel
``csrc/greedy_nms.cu`` on the card, its plain version on the CPU. The
JAX package runs the same scan as a ``lax.scan`` (``_greedy_nms_mask``)
and holds its Pallas kernel equal to that scan; the port computes the
same function, routed to the kernel. ``lax.top_k`` keeps the lower
index first among equal values and ``torch.topk`` promises no order on
CUDA, so every top-k here is the head of a stable descending sort.

``yolov3_loss`` keeps the reference's arithmetic op for op and reads
nothing on the host, so a train step that calls it can be captured as a
CUDA graph: gathers at the assigned cells are tensor indexing, the
objectness target a scatter-max over flat cell indices. The backward of
the cell gather (:class:`_CellGather`) is deterministic: gradients of gt
boxes that share a cell are summed in gt order, then written once.

The other ops of the JAX module (``prior_box``, ``box_coder``,
``generate_proposals``, ...) are not ported yet (ROADMAP.md queue A9).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import amp
from .custom import greedy_nms

__all__ = ["yolo_box", "iou_similarity", "box_clip", "multiclass_nms",
           "yolov3_loss"]


def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# -- yolo_box -----------------------------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode one YOLO head (reference: detection/yolo_box_op.cc).

    x: ``[N, A*(5+C), H, W]``; img_size: ``[N, 2]`` (h, w). Returns boxes
    ``[N, A*H*W, 4]`` (x1y1x2y2 in image scale) and scores
    ``[N, A*H*W, C]``; boxes and scores with conf < conf_thresh are 0."""
    anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    a_n = anchors.shape[0]
    c_n = int(class_num)
    n, _, h, w = x.shape
    dt, dev = x.dtype, x.device
    p = x.reshape(n, a_n, 5 + c_n, h, w)
    grid_x = torch.arange(w, dtype=dt, device=dev).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, dtype=dt, device=dev).reshape(1, 1, h, 1)
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(p[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(p[:, :, 1]) * alpha + beta + grid_y) / h
    input_h = h * downsample_ratio
    input_w = w * downsample_ratio
    an_w = torch.from_numpy((anchors[:, 0] / input_w).reshape(1, a_n, 1, 1)
                            ).to(dev, dt)
    an_h = torch.from_numpy((anchors[:, 1] / input_h).reshape(1, a_n, 1, 1)
                            ).to(dev, dt)
    bw = torch.exp(p[:, :, 2]) * an_w
    bh = torch.exp(p[:, :, 3]) * an_h
    conf = torch.sigmoid(p[:, :, 4])
    keep = conf >= conf_thresh
    img_h = img_size[:, 0].to(dt).reshape(n, 1, 1, 1)
    img_w = img_size[:, 1].to(dt).reshape(n, 1, 1, 1)
    x1 = (bx - bw / 2) * img_w
    y1 = (by - bh / 2) * img_h
    x2 = (bx + bw / 2) * img_w
    y2 = (by + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    scores = conf[..., None] * torch.sigmoid(torch.movedim(p[:, :, 5:], 2, -1))
    scores = torch.where(keep[..., None], scores, torch.zeros_like(scores))
    # [N, A, H, W, k] -> [N, A*H*W, k]
    return (boxes.reshape(n, a_n * h * w, 4),
            scores.reshape(n, a_n * h * w, c_n))


# -- iou helpers --------------------------------------------------------------

def _pairwise_iou(a, b, normalized=True):
    """a ``[..., M, 4]``, b ``[..., K, 4]`` x1y1x2y2 -> ``[..., M, K]``.
    Unnormalized (pixel) boxes get the reference's +1 extent offset
    (JaccardOverlap, detection/nms_util.h)."""
    off = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + off).clamp(min=0) * \
        (a[..., 3] - a[..., 1] + off).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0] + off).clamp(min=0) * \
        (b[..., 3] - b[..., 1] + off).clamp(min=0)

    def extent(lo, hi):
        left = torch.maximum(a[..., :, None, lo], b[..., None, :, lo])
        right = torch.minimum(a[..., :, None, hi], b[..., None, :, hi])
        return (right - left + off).clamp(min=0)

    inter = extent(0, 2) * extent(1, 3)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_similarity(x, y, box_normalized=True, name=None):
    """reference: detection/iou_similarity_op.cc — [M,4]x[K,4] -> [M,K]."""
    return _pairwise_iou(x, y, normalized=box_normalized)


def box_clip(input, im_info, name=None):
    """reference: detection/box_clip_op.cc — clip to [0, dim-1], with
    ``im_info = (h, w, ...)``."""
    h, w = im_info[0], im_info[1]
    zero = torch.zeros((), dtype=input.dtype, device=input.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), (hi - 1).to(v.dtype))
    return torch.stack([clip(input[..., 0], w), clip(input[..., 1], h),
                        clip(input[..., 2], w), clip(input[..., 3], h)],
                       dim=-1)


# -- multiclass_nms -----------------------------------------------------------

def _candidates(boxes, scores, top_k, normalized=True):
    """The ``min(top_k, M)`` best candidates of each problem and their
    IoU matrices. boxes ``[..., M, 4]`` (broadcast against the leading
    dims of scores), scores ``[..., M]`` -> top_scores ``[..., k]``,
    order ``[..., k]``, candidate boxes ``[..., k, 4]``, iou
    ``[..., k, k]``."""
    k = min(int(top_k), scores.shape[-1])
    top_scores, order = _top_k(scores, k)
    boxes = boxes.expand(*scores.shape, 4)
    cand = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    return top_scores, order, cand, _pairwise_iou(cand, cand, normalized)


def _nms_kept(iou, valid, iou_threshold, nms_eta=1.0):
    """The greedy scan of every problem in one :func:`greedy_nms` call:
    iou ``[..., k, k]``, valid ``[..., k]`` bool -> kept ``[..., k]``
    bool."""
    lead, k = valid.shape[:-1], valid.shape[-1]
    p_n = int(np.prod(lead, dtype=np.int64))
    thr = torch.full((p_n,), float(iou_threshold), dtype=torch.float32,
                     device=iou.device)
    kept = greedy_nms(iou.reshape(p_n, k, k).float().contiguous(),
                      valid.reshape(p_n, k).to(torch.int32).contiguous(),
                      thr, nms_eta)
    return kept.reshape(*lead, k) != 0


def _greedy_nms_mask(boxes, scores, iou_threshold, score_threshold, top_k,
                     normalized=True, nms_eta=1.0):
    """Greedy suppression over score-sorted candidates, for any leading
    batch dims. Returns (kept mask over the top_k sorted slots, their
    indices, their scores). ``nms_eta < 1`` decays the threshold after
    each kept box while it stays above 0.5 (reference:
    detection/nms_util.h NMSFast adaptive_threshold)."""
    top_scores, order, _, iou = _candidates(boxes, scores, top_k,
                                            normalized)
    kept = _nms_kept(iou, top_scores > score_threshold, iou_threshold,
                     nms_eta)
    return kept, order, top_scores


def _class_candidates(bboxes, scores, nms_top_k, normalized=True,
                      background_label=0):
    """Per (image, non-background class): top scores ``[N, C', k]``,
    labels ``[C']`` (class ids), candidate boxes ``[N, C', k, 4]`` and
    IoU ``[N, C', k, k]``."""
    classes = [c for c in range(scores.shape[1]) if c != background_label]
    sc = scores[:, classes] if len(classes) < scores.shape[1] else scores
    top_scores, _, cand, iou = _candidates(bboxes[:, None], sc, nms_top_k,
                                           normalized)
    labels = torch.tensor(classes, dtype=scores.dtype, device=scores.device)
    return top_scores, labels, cand, iou


def _select_detections(top_scores, labels, cand, kept, keep_top_k):
    """The ``keep_top_k`` best kept candidates of each image over all
    classes: rows (label, score, x1, y1, x2, y2) padded with label -1,
    and int32 counts."""
    n, c_n, k = top_scores.shape
    all_scores = torch.where(kept, top_scores,
                             torch.full_like(top_scores, -1.0)
                             ).reshape(n, c_n * k)
    all_labels = labels[:, None].expand(c_n, k).reshape(c_n * k)
    all_boxes = cand.reshape(n, c_n * k, 4)
    kk = min(int(keep_top_k), c_n * k)
    best, idx = _top_k(all_scores, kk)
    valid = best >= 0
    lab = torch.where(valid, all_labels[idx], torch.full_like(best, -1.0))
    score = torch.where(valid, best, torch.zeros_like(best))
    box = torch.gather(all_boxes, 1, idx[..., None].expand(n, kk, 4))
    box = torch.where(valid[..., None], box, torch.zeros_like(box))
    out = torch.cat([lab[..., None], score[..., None], box], dim=-1)
    if kk < keep_top_k:
        pad = torch.zeros((n, keep_top_k - kk, 6), dtype=out.dtype,
                          device=out.device)
        pad[..., 0] = -1.0
        out = torch.cat([out, pad], dim=1)
    return out, valid.sum(dim=-1).to(torch.int32)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None,
                   return_index=False):
    """reference: detection/multiclass_nms_op.cc (MultiClassNMS kernel).

    bboxes: ``[N, M, 4]``; scores: ``[N, C, M]``. Fixed-size output: out
    ``[N, keep_top_k, 6]`` rows (label, score, x1, y1, x2, y2), padded
    rows have label -1; counts ``[N]`` int32. As in the JAX package,
    ``return_index`` is accepted and no index is returned."""
    top_scores, labels, cand, iou = _class_candidates(
        bboxes, scores, nms_top_k, normalized, background_label)
    kept = _nms_kept(iou, top_scores > score_threshold, nms_threshold,
                     nms_eta)
    return _select_detections(top_scores, labels, cand, kept, keep_top_k)


# -- yolov3_loss --------------------------------------------------------------

def _bce(pred_logit, target):
    """The reference's BCE on a logit, through ``sigmoid`` and ``log``
    with eps 1e-7 (not the fused logit form, which rounds otherwise)."""
    p = torch.sigmoid(pred_logit)
    eps = 1e-7
    return -(target * torch.log(p + eps)
             + (1 - target) * torch.log(1 - p + eps))


class _CellGather(torch.autograd.Function):
    """``p[b, a[b, g], :, j[b, g], i[b, g]]`` -> ``[N, G, K]`` with a
    deterministic backward. Gt boxes on one cell gather the same entries;
    the gradient of each entry is the sum of theirs in gt order (a fixed
    reduction over a ``[N, G, G]`` same-cell mask), written once per
    cell, where the default backward of indexing would add them with
    atomics on the card."""

    @staticmethod
    def forward(ctx, p, bidx, a, j, i):
        ctx.save_for_backward(bidx, a, j, i)
        ctx.shape = p.shape
        return p[bidx, a, :, j, i]

    @staticmethod
    def backward(ctx, grad):
        bidx, a, j, i = ctx.saved_tensors
        n, _, _, h, w = ctx.shape
        cell = (a * h + j) * w + i                          # [N, G]
        same = (cell[:, :, None] == cell[:, None, :]).to(grad.dtype)
        summed = (same[..., None] * grad[:, None, :, :]).sum(dim=2)
        out = grad.new_zeros(ctx.shape)
        out[bidx, a, :, j, i] = summed
        return out, None, None, None, None


#: small constant vectors of the loss on each device, made once by scalar
#: fills (a host-to-device copy would not be capturable in a CUDA graph)
_CONSTS = {}


def _device_const(values, device, dtype):
    key = (tuple(float(v) for v in values), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.empty(len(key[0]), dtype=dtype, device=device)
        for k, v in enumerate(key[0]):
            t[k] = v
        _CONSTS[key] = t
    return t


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=False, name=None, scale_x_y=1.0):
    """reference: detection/yolov3_loss_op.cc, as the JAX package writes
    it (``paddle_tpu/ops/detection.py:321-430``).

    x: ``[N, A*(5+C), H, W]`` raw predictions of one scale; gt_box:
    ``[N, B, 4]`` (cx, cy, w, h normalized to [0, 1]), zero-padded slots;
    gt_label: ``[N, B]`` int; anchors: the full anchor list (pairs);
    anchor_mask: this scale's anchors. Returns the loss of each image,
    ``[N]``: BCE on x/y, objectness and classes, squared error on w/h,
    the size weight ``2 - w*h``, and no-object loss ignored where the
    best IoU of the (detached) predicted box with a valid gt box exceeds
    ``ignore_thresh``. ``gt_score`` is accepted and not read, and so is
    ``scale_x_y``, as in the JAX package. Under AMP the op is
    ``"yolov3_loss"``, in no list: O1 passes its inputs through."""
    x, gt_box, gt_label, _ = amp.cast_inputs("yolov3_loss", x, gt_box,
                                             gt_label, gt_score)
    all_anchors = np.asarray(anchors, np.float32).reshape(-1, 2)
    mask = list(anchor_mask)
    a_n = len(mask)
    c_n = int(class_num)
    n, _, h, w = x.shape
    dt, dev = x.dtype, x.device
    f32 = torch.float32
    p = x.reshape(n, a_n, 5 + c_n, h, w)
    norm = all_anchors / np.array([float(w * downsample_ratio),
                                   float(h * downsample_ratio)], np.float32)
    all_w = _device_const(norm[:, 0], dev, f32)             # [Atot]
    all_h = _device_const(norm[:, 1], dev, f32)
    an_w = _device_const(norm[mask, 0], dev, f32)           # [A]
    an_h = _device_const(norm[mask, 1], dev, f32)
    gbox = gt_box
    valid = (gbox[..., 2] > 0) & (gbox[..., 3] > 0)          # [N, B]

    # best anchor of each gt box: shape-only IoU against every anchor
    gw = gbox[..., 2][..., None]
    gh = gbox[..., 3][..., None]
    inter = torch.minimum(gw, all_w) * torch.minimum(gh, all_h)
    union = gw * gh + all_w * all_h - inter
    shape_iou = inter / (union + 1e-9)                       # [N, B, Atot]
    best_anchor = torch.argmax(shape_iou, dim=-1)           # first maximum
    mask_arr = _device_const(mask, dev, best_anchor.dtype)
    in_mask = best_anchor[..., None] == mask_arr             # [N, B, A]
    local_a = torch.argmax(in_mask.to(torch.uint8), dim=-1)  # first True
    responsible = valid & in_mask.any(dim=-1)

    # truncate toward zero, then clip, as astype(int32) then clip
    gi = (gbox[..., 0] * w).to(torch.int32).clamp(0, w - 1)
    gj = (gbox[..., 1] * h).to(torch.int32).clamp(0, h - 1)
    tx = gbox[..., 0] * w - gi
    ty = gbox[..., 1] * h - gj
    tw = torch.log(gbox[..., 2] / (an_w[local_a] + 1e-9) + 1e-9)
    th = torch.log(gbox[..., 3] / (an_h[local_a] + 1e-9) + 1e-9)
    box_w = 2.0 - gbox[..., 2] * gbox[..., 3]               # size weight

    # predictions at the assigned cells: [N, B, 5 + C]
    bidx = torch.arange(n, device=dev)[:, None].expand(n, gi.shape[1])
    gil, gjl = gi.long(), gj.long()
    cells = _CellGather.apply(p, bidx, local_a, gjl, gil)
    px, py, pw, ph = (cells[..., k] for k in range(4))
    pcls = cells[..., 5:]

    rmask = responsible.to(dt)
    loss_xy = (_bce(px, tx) + _bce(py, ty)) * box_w * rmask
    loss_wh = ((pw - tw) ** 2 + (ph - th) ** 2) * 0.5 * box_w * rmask
    smooth = 1.0 / max(c_n, 1) if use_label_smooth else 0.0
    # jax.nn.one_hot: float32, a label outside [0, C) gives a zero row
    onehot = (gt_label[..., None].long()
              == torch.arange(c_n, device=dev)).to(f32)
    onehot = onehot * (1 - 2 * smooth) + smooth
    loss_cls = torch.sum(_bce(pcls, onehot), dim=-1) * rmask

    # objectness: target 1 at responsible cells (a scatter-max, as gt
    # boxes may share a cell); 0 elsewhere unless the predicted box
    # overlaps some gt box above ignore_thresh
    obj_logit = p[:, :, 4]                                   # [N, A, H, W]
    flat = ((bidx * a_n + local_a) * h + gjl) * w + gil
    tobj = torch.zeros(n * a_n * h * w, dtype=dt, device=dev).scatter_reduce(
        0, flat.reshape(-1), rmask.reshape(-1), reduce="amax",
        include_self=True).reshape(n, a_n, h, w)

    pd = p.detach()
    grid_x = torch.arange(w, dtype=dt, device=dev).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, dtype=dt, device=dev).reshape(1, 1, h, 1)
    bx = (torch.sigmoid(pd[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(pd[:, :, 1]) + grid_y) / h
    bw = torch.exp(torch.clamp(pd[:, :, 2], -10, 10)) * an_w.reshape(
        1, a_n, 1, 1)
    bh = torch.exp(torch.clamp(pd[:, :, 3], -10, 10)) * an_h.reshape(
        1, a_n, 1, 1)
    pred_xyxy = torch.stack([bx - bw / 2, by - bh / 2,
                             bx + bw / 2, by + bh / 2], -1)  # [N,A,H,W,4]
    g_xyxy = torch.stack([gbox[..., 0] - gbox[..., 2] / 2,
                          gbox[..., 1] - gbox[..., 3] / 2,
                          gbox[..., 0] + gbox[..., 2] / 2,
                          gbox[..., 1] + gbox[..., 3] / 2], -1)  # [N,B,4]
    iou = _pairwise_iou(pred_xyxy.reshape(n, -1, 4), g_xyxy)   # [N,AHW,B]
    iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
    best_iou = iou.max(dim=-1).values.reshape(n, a_n, h, w)
    noobj_mask = ((best_iou < ignore_thresh) & (tobj < 0.5)).to(dt)
    loss_obj = (_bce(obj_logit, torch.ones_like(tobj)) * tobj
                + _bce(obj_logit, torch.zeros_like(tobj)) * noobj_mask)

    return (loss_xy.sum(dim=1) + loss_wh.sum(dim=1) + loss_cls.sum(dim=1)
            + loss_obj.sum(dim=(1, 2, 3)))
