"""Detection ops (counterpart of ``paddle_tpu/ops/detection.py``, in
full): ``yolo_box``, ``iou_similarity``, ``box_clip``,
``multiclass_nms`` and ``yolov3_loss`` of the YOLOv3 paths; the prior
boxes and anchors (``prior_box``, ``density_prior_box``,
``anchor_generator``), box coding (``box_coder``,
``box_decoder_and_assign``), the RPN and the FPN
(``generate_proposals``, ``collect_fpn_proposals``,
``distribute_fpn_proposals``), the RoI poolings (``roi_align``,
``roi_pool``, ``psroi_pool``, ``prroi_pool``,
``deformable_psroi_pooling``), ``matrix_nms``, matching and assignment
(``bipartite_match``, ``target_assign``), ``smooth_l1`` and
``polygon_box_transform``.

Outputs keep the JAX package's fixed sizes: ``multiclass_nms`` and
``matrix_nms`` return exactly ``keep_top_k`` rows per image, padded rows
carry label -1, and an int32 count per image says how many rows are
real; ``generate_proposals`` pads to ``post_nms_top_n`` rois;
``distribute_fpn_proposals`` gives every level all the rois, masked.

``multiclass_nms`` takes the top ``nms_top_k`` candidates of every
(image, class) pair, builds their IoU matrices on the device and runs
the greedy scan for all pairs at once through
:func:`paddle_tpu_torch.ops.custom.greedy_nms`: the CUDA kernel
``csrc/greedy_nms.cu`` on the card, its plain version on the CPU.
``generate_proposals`` runs every image's scan in one such call. The
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
boxes that share a cell are summed in gt order, then written once. The
RoI ops read ``rois_num`` on the host, as the JAX package does, and so
raise inside a capture.
"""
from __future__ import annotations

import numpy as np
import torch

from .custom import greedy_nms
from .dispatch import apply, capturing, host_array

__all__ = ["yolo_box", "yolov3_loss", "multiclass_nms", "prior_box",
           "box_coder", "iou_similarity", "box_clip", "roi_align", "roi_pool",
           "anchor_generator", "generate_proposals",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "bipartite_match", "target_assign", "box_decoder_and_assign",
           "polygon_box_transform", "smooth_l1", "matrix_nms",
           "density_prior_box", "psroi_pool", "prroi_pool",
           "deformable_psroi_pooling"]


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
    return apply("yolo_box", _yolo_box, x, img_size, anchors=anchors,
                 class_num=class_num, conf_thresh=conf_thresh,
                 downsample_ratio=downsample_ratio, clip_bbox=clip_bbox,
                 scale_x_y=scale_x_y)


def _yolo_box(x, img_size, anchors, class_num, conf_thresh,
              downsample_ratio, clip_bbox, scale_x_y):
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
    return apply("iou_similarity", _pairwise_iou, x, y,
                 normalized=box_normalized)


def box_clip(input, im_info, name=None):
    """reference: detection/box_clip_op.cc — clip to [0, dim-1], with
    ``im_info = (h, w, ...)``."""
    return apply("box_clip", _box_clip, input, im_info)


def _box_clip(input, im_info):
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
    return apply("multiclass_nms", _multiclass_nms, bboxes, scores,
                 score_threshold=score_threshold, nms_top_k=nms_top_k,
                 keep_top_k=keep_top_k, nms_threshold=nms_threshold,
                 normalized=normalized, nms_eta=nms_eta,
                 background_label=background_label)


def _multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold, normalized, nms_eta, background_label):
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
    return apply("yolov3_loss", _yolov3_loss, x, gt_box, gt_label, gt_score,
                 anchors=anchors, anchor_mask=anchor_mask,
                 class_num=class_num, ignore_thresh=ignore_thresh,
                 downsample_ratio=downsample_ratio,
                 use_label_smooth=use_label_smooth)


def _yolov3_loss(x, gt_box, gt_label, gt_score, anchors, anchor_mask,
                 class_num, ignore_thresh, downsample_ratio,
                 use_label_smooth):
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


# -- prior boxes and anchors ----------------------------------------------------

def _whs_prior(min_sizes, max_sizes, ars, mm_order):
    whs = []
    for ms in min_sizes:
        mx = max_sizes[min_sizes.index(ms)] if max_sizes else None
        if mm_order:
            whs.append((ms, ms))
            if mx is not None:
                whs.append((float(np.sqrt(ms * mx)),) * 2)
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars
                    if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in ars]
            if mx is not None:
                whs.append((float(np.sqrt(ms * mx)),) * 2)
    return whs


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """reference: detection/prior_box_op.cc (SSD prior boxes): boxes and
    variances ``[H, W, P, 4]``, normalized by the image's size."""
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    min_sizes = [float(s) for s in np.atleast_1d(min_sizes)]
    max_sizes = [float(s) for s in np.atleast_1d(max_sizes)] if max_sizes \
        else []
    whs = _whs_prior(min_sizes, max_sizes, ars, min_max_aspect_ratios_order)
    return apply("prior_box", _prior_box, input, image, whs=whs,
                 variance=variance, clip=clip, steps=steps, offset=offset)


def _centers(n, offset, step, dev):
    return (torch.arange(n, dtype=torch.float32, device=dev) + offset) * step


def _prior_box(feat, img, whs, variance, clip, steps, offset):
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    dev = feat.device
    cy = _centers(fh, offset, steps[1] if steps[1] > 0 else ih / fh, dev)
    cx = _centers(fw, offset, steps[0] if steps[0] > 0 else iw / fw, dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    wh = _device_const(np.asarray(whs, np.float32).reshape(-1), dev,
                       torch.float32).reshape(-1, 2)
    boxes = torch.stack([
        (cxg[..., None] - wh[:, 0] / 2) / iw,
        (cyg[..., None] - wh[:, 1] / 2) / ih,
        (cxg[..., None] + wh[:, 0] / 2) / iw,
        (cyg[..., None] + wh[:, 1] / 2) / ih], dim=-1)     # [H, W, P, 4]
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = _device_const(np.asarray(variance, np.float32), dev,
                        torch.float32).expand(boxes.shape)
    return boxes, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    """reference: detection/density_prior_box_op.cc (SSD's densified
    anchors): ``[H, W, A, 4]`` or, flattened, ``[H*W*A, 4]``."""
    per_loc = []
    for density, fs in zip(densities, fixed_sizes):
        for fr in fixed_ratios:
            bw, bh = fs * np.sqrt(fr), fs / np.sqrt(fr)
            shift = fs / density
            for di in range(density):
                for dj in range(density):
                    per_loc.append((-fs / 2.0 + shift / 2.0 + dj * shift,
                                    -fs / 2.0 + shift / 2.0 + di * shift,
                                    bw, bh))
    return apply("density_prior_box", _density_prior_box, input, image,
                 per_loc=per_loc, variance=variance, clip=clip, steps=steps,
                 offset=offset, flatten_to_2d=flatten_to_2d)


def _density_prior_box(x, img, per_loc, variance, clip, steps, offset,
                       flatten_to_2d):
    h, w = x.shape[2], x.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    dev = x.device
    cx = _centers(w, offset, steps[0] or iw / w, dev)
    cy = _centers(h, offset, steps[1] or ih / h, dev)
    prm = _device_const(np.asarray(per_loc, np.float32).reshape(-1), dev,
                        torch.float32).reshape(-1, 4)
    bx = cx[None, :, None] + prm[None, None, :, 0] + 0 * cy[:, None, None]
    by = cy[:, None, None] + prm[None, None, :, 1] + 0 * cx[None, :, None]
    bw, bh = prm[None, None, :, 2], prm[None, None, :, 3]
    out = torch.stack([(bx - bw / 2) / iw, (by - bh / 2) / ih,
                       (bx + bw / 2) / iw, (by + bh / 2) / ih], dim=-1)
    if clip:
        out = out.clamp(0.0, 1.0)
    v = _device_const(np.asarray(variance, np.float32), dev,
                      torch.float32).expand(out.shape)
    if flatten_to_2d:
        return out.reshape(-1, 4), v.reshape(-1, 4)
    return out, v


def anchor_generator(input, anchor_sizes, aspect_ratios, variances,
                     stride, offset=0.5, name=None):
    """reference: detection/anchor_generator_op.cc: grid anchors
    ``[H, W, A, 4]`` (ratios outer, sizes inner) and their variances."""
    sizes = [float(s) for s in np.atleast_1d(anchor_sizes)]
    ratios = [float(r) for r in np.atleast_1d(aspect_ratios)]
    ws = [s * np.sqrt(1.0 / r) for r in ratios for s in sizes]
    hs = [s * np.sqrt(r) for r in ratios for s in sizes]
    sx, sy = (stride if isinstance(stride, (list, tuple))
              else (stride, stride))
    return apply("anchor_generator", _anchor_generator, input, ws=ws, hs=hs,
                 variances=variances, sx=sx, sy=sy, offset=offset)


def _anchor_generator(x, ws, hs, variances, sx, sy, offset):
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    # int arange + offset, times the stride, as the JAX package's
    cx = (torch.arange(w, device=dev) + offset) * sx
    cy = (torch.arange(h, device=dev) + offset) * sy
    cx, cy = cx.float(), cy.float()
    wv = _device_const(np.asarray(ws, np.float32), dev, torch.float32)
    hv = _device_const(np.asarray(hs, np.float32), dev, torch.float32)
    boxes = torch.stack([
        cx[None, :, None] - 0.5 * wv[None, None, :] + 0 * cy[:, None, None],
        cy[:, None, None] - 0.5 * hv[None, None, :] + 0 * cx[None, :, None],
        cx[None, :, None] + 0.5 * wv[None, None, :] + 0 * cy[:, None, None],
        cy[:, None, None] + 0.5 * hv[None, None, :] + 0 * cx[None, :, None],
    ], dim=-1)                                         # [H, W, A, 4]
    v = _device_const(np.asarray(variances, np.float32), dev,
                      torch.float32).expand(boxes.shape)
    return boxes, v


# -- box coding -------------------------------------------------------------------

def box_coder(prior_box_t, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """reference: detection/box_coder_op.cc: ``encode_center_size`` gives
    ``[N, M, 4]`` offsets of targets ``[N, 4]`` from priors ``[M, 4]``;
    ``decode_center_size`` decodes offsets ``[..., M, 4]`` against the
    priors. ``prior_box_var`` is a tensor (broadcast against the boxes)
    or None."""
    return apply("box_coder", _box_coder, prior_box_t, prior_box_var,
                 target_box, code_type=code_type,
                 norm=1.0 if box_normalized else 0.0)


def _cwh(b, norm):
    w = b[..., 2] - b[..., 0] + (1.0 - norm)
    h = b[..., 3] - b[..., 1] + (1.0 - norm)
    return b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h, w, h


def _box_coder(prior, pvar, target, code_type, norm):
    pcx, pcy, pw, ph = _cwh(prior, norm)
    if code_type == "encode_center_size":
        tcx, tcy, tw, th = _cwh(target[:, None, :] if target.dim() == 2
                                else target, norm)
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(torch.abs(tw / pw)),
                           torch.log(torch.abs(th / ph))], dim=-1)
        return out if pvar is None else out / pvar
    t = target if pvar is None else target * pvar
    ocx = t[..., 0] * pw + pcx
    ocy = t[..., 1] * ph + pcy
    ow = torch.exp(t[..., 2]) * pw
    oh = torch.exp(t[..., 3]) * ph
    return torch.stack([ocx - ow / 2, ocy - oh / 2,
                        ocx + ow / 2 - (1.0 - norm),
                        ocy + oh / 2 - (1.0 - norm)], dim=-1)


def box_decoder_and_assign(prior_box_t, prior_box_var, target_box,
                           box_score, box_clip=4.135, name=None):
    """reference: detection/box_decoder_and_assign_op.cc: decode each
    class's deltas, then give each box the decode of its best-scoring
    non-background class."""
    return apply("box_decoder_and_assign", _box_decoder_and_assign,
                 prior_box_t, prior_box_var, target_box, box_score,
                 box_clip=box_clip)


def _box_decoder_and_assign(pb, pbv, tb, sc, box_clip):
    n, c4 = pb.shape[0], tb.shape[1]
    pw = pb[:, 2] - pb[:, 0] + 1.0
    phh = pb[:, 3] - pb[:, 1] + 1.0
    pcx = pb[:, 0] + 0.5 * pw
    pcy = pb[:, 1] + 0.5 * phh
    d = tb.reshape(n, c4 // 4, 4)
    dx = d[..., 0] * pbv[:, None, 0]
    dy = d[..., 1] * pbv[:, None, 1]
    dw = torch.clamp(d[..., 2] * pbv[:, None, 2], max=box_clip)
    dh = torch.clamp(d[..., 3] * pbv[:, None, 3], max=box_clip)
    cx = dx * pw[:, None] + pcx[:, None]
    cy = dy * phh[:, None] + pcy[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * phh[:, None]
    decoded = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w - 1, cy + 0.5 * h - 1], dim=-1)
    best = torch.argmax(sc[:, 1:], dim=1) + 1        # first index on ties
    assigned = torch.take_along_dim(decoded, best[:, None, None].expand(
        n, 1, 4), dim=1)[:, 0]
    return decoded.reshape(n, c4), assigned


# -- the RPN and the FPN -----------------------------------------------------

def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """reference: detection/generate_proposals_op.cc (the RPN): decode
    deltas against anchors, clip to the image, drop small boxes, keep the
    ``pre_nms_top_n`` best, run greedy NMS, keep the ``post_nms_top_n``
    best. Fixed-size outputs: rois ``[N, post_nms_top_n, 4]``, scores
    ``[N, post_nms_top_n]`` (padding 0) and rois_num ``[N]`` int32.

    Every image's greedy scan runs in ONE :func:`greedy_nms` call of N
    problems (the kernel B5 on CUDA), as ``multiclass_nms`` batches its
    classes; the JAX package scans each image (``:684``)."""
    return apply("generate_proposals", _generate_proposals, scores,
                 bbox_deltas, im_shape, anchors, variances,
                 pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                 nms_thresh=nms_thresh, min_size=min_size, eta=eta,
                 pixel_offset=pixel_offset)


def _flat_hwa(t, n, cols):
    """``[N, A*cols, H, W]`` (or already flat) -> ``[N, H*W*A, cols]``,
    the order of ``anchor_generator``'s ``[H, W, A, 4]``."""
    if t.dim() == 4:
        h, w = t.shape[-2], t.shape[-1]
        return t.reshape(n, -1, cols, h, w).permute(0, 3, 4, 1, 2).reshape(
            n, -1, cols)
    return t.reshape(n, -1, cols)


def _generate_proposals(sc, deltas, imshape, anc, var, pre_nms_top_n,
                        post_nms_top_n, nms_thresh, min_size, eta,
                        pixel_offset):
    off = 1.0 if pixel_offset else 0.0
    n = sc.shape[0]
    anc_f, var_f = anc.reshape(-1, 4), var.reshape(-1, 4)
    s_f = _flat_hwa(sc, n, 1)[..., 0]                     # [N, M]
    d_f = _flat_hwa(deltas, n, 4)                         # [N, M, 4]
    aw = anc_f[:, 2] - anc_f[:, 0] + off
    ah = anc_f[:, 3] - anc_f[:, 1] + off
    acx = anc_f[:, 0] + 0.5 * aw
    acy = anc_f[:, 1] + 0.5 * ah
    cx = var_f[:, 0] * d_f[..., 0] * aw + acx
    cy = var_f[:, 1] * d_f[..., 1] * ah + acy
    w = torch.exp(torch.clamp(var_f[:, 2] * d_f[..., 2], max=10.0)) * aw
    h = torch.exp(torch.clamp(var_f[:, 3] * d_f[..., 3], max=10.0)) * ah
    hgt = imshape[:, 0:1].to(w.dtype)
    wid = imshape[:, 1:2].to(w.dtype)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - off)
    boxes = torch.stack([clip(cx - 0.5 * w, wid), clip(cy - 0.5 * h, hgt),
                         clip(cx + 0.5 * w - off, wid),
                         clip(cy + 0.5 * h - off, hgt)], dim=-1)
    ww = boxes[..., 2] - boxes[..., 0] + off
    hh = boxes[..., 3] - boxes[..., 1] + off
    ninf = torch.full((), -float("inf"), dtype=s_f.dtype, device=s_f.device)
    s_m = torch.where((ww >= min_size) & (hh >= min_size), s_f, ninf)
    k = min(int(pre_nms_top_n), s_m.shape[-1])
    top_s, top_i = _top_k(s_m, k)
    cand = torch.gather(boxes, 1, top_i[..., None].expand(n, k, 4))
    kept, order, kept_s = _greedy_nms_mask(
        cand, top_s, nms_thresh, -float("inf"), k,
        normalized=not pixel_offset, nms_eta=eta)
    sel = torch.where(kept & torch.isfinite(kept_s), kept_s, ninf)
    kk = min(int(post_nms_top_n), k)
    fin_s, fin_i = _top_k(sel, kk)
    fin_boxes = torch.gather(cand, 1, torch.gather(order, 1, fin_i)[
        ..., None].expand(n, kk, 4))
    valid = torch.isfinite(fin_s)
    out_boxes = torch.where(valid[..., None], fin_boxes,
                            torch.zeros_like(fin_boxes))
    out_s = torch.where(valid, fin_s, torch.zeros_like(fin_s))
    if kk < post_nms_top_n:
        pad = post_nms_top_n - kk
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(n, pad, 4)], 1)
        out_s = torch.cat([out_s, out_s.new_zeros(n, pad)], 1)
    return out_boxes, out_s, valid.sum(dim=1).to(torch.int32)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, pixel_offset=False,
                             name=None):
    """reference: detection/distribute_fpn_proposals_op.cc: each roi goes
    to the FPN level of its scale. Masked fixed-size outputs: a list of
    ``[R, 4]`` rois (zero where not of the level) and a list of ``[R]``
    masks, one each per level, and ``restore_index`` ``[R]`` int32."""
    levels = list(range(int(min_level), int(max_level) + 1))
    flat = apply("distribute_fpn_proposals", _distribute_fpn_proposals,
                 fpn_rois, levels=levels, refer_level=refer_level,
                 refer_scale=refer_scale, off=1.0 if pixel_offset else 0.0)
    n = len(levels)
    return list(flat[:n]), list(flat[n:2 * n]), flat[2 * n]


def _distribute_fpn_proposals(rois, levels, refer_level, refer_scale, off):
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = torch.sqrt(torch.clamp(w * h, min=1e-12))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = lvl.clamp(levels[0], levels[-1]).to(torch.int32)
    outs = [torch.where((lvl == lv)[:, None], rois, torch.zeros_like(rois))
            for lv in levels]
    masks = [lvl == lv for lv in levels]
    r = rois.shape[0]
    key = lvl.to(torch.int64) * r + torch.arange(r, device=rois.device)
    perm = torch.argsort(key, stable=True)
    restore = torch.argsort(perm, stable=True).to(torch.int32)
    return (*outs, *masks, restore)


def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n,
                          rois_num_per_level=None, name=None):
    """reference: detection/collect_fpn_proposals_op.cc: the levels' rois
    ``[R_l, 4]`` merged, the ``post_nms_top_n`` best by score kept."""
    return apply("collect_fpn_proposals", _collect_fpn_proposals,
                 *(list(multi_rois) + list(multi_scores)),
                 k=int(post_nms_top_n))


def _collect_fpn_proposals(*args, k):
    n = len(args) // 2
    rois = torch.cat(args[:n], dim=0)
    scores = torch.cat([a.reshape(-1) for a in args[n:]], dim=0)
    top_s, top_i = _top_k(scores, min(k, scores.shape[0]))
    return rois[top_i], top_s


# -- RoI pooling ----------------------------------------------------------------

def _batch_index(op, rois_num, r, dev):
    """The image of each roi ``[R]`` int64, from ``rois_num`` read on the
    host (the JAX package's LoD replacement); raises inside a capture."""
    if rois_num is None:
        return torch.zeros(r, dtype=torch.int64, device=dev)
    rn = host_array(op, "rois_num", rois_num)
    return torch.from_numpy(np.repeat(np.arange(rn.shape[0]), rn)).to(dev)


def _chunks(r, per_roi, budget=1 << 25):
    """Slices of the rois such that a chunk's intermediate of ``per_roi``
    elements a roi stays under ``budget`` elements."""
    step = max(1, budget // max(int(per_roi), 1))
    return [slice(i, min(i + step, r)) for i in range(0, r, step)]


def _pooled(output_size):
    if isinstance(output_size, int):
        return int(output_size), int(output_size)
    return int(output_size[0]), int(output_size[1])


def roi_align(input, rois, output_size, spatial_scale=1.0, sampling_ratio=-1,
              rois_num=None, aligned=True, name=None):
    """reference: operators/roi_align_op.cc, as the JAX package lays it
    out (``:433-535``). input ``[N, C, H, W]``; rois ``[R, 4]`` (x1, y1,
    x2, y2 in input-image coordinates); ``rois_num`` ``[N]`` maps rois to
    images (read on the host). Output ``[R, C, ph, pw]``.

    ``sampling_ratio <= 0`` takes ``ceil(bin extent)`` taps a bin and axis
    on a static grid of ``min(ceil(H/ph), 8)`` x ``min(ceil(W/pw), 8)``
    (the JAX package's 8-tap cap), each roi's taps past its count masked;
    a tap in ``(-1, 0)`` is clamped to the border before the corner
    split. The JAX package materialises every tap of every roi at once
    (``[R, C, ph, Gy, pw, Gx]`` for each corner); the port accumulates
    the same taps, masks and average one tap position at a time, its
    four corners gathered as rows of a channels-last copy of the input,
    so the peak intermediate is four ``[R, ph, pw, C]`` corners. Outside
    a CUDA graph capture it reads the largest tap count of the rois on
    the host and skips the grid's positions no roi uses (they would add
    exact zeros); inside one it runs the whole static grid."""
    ph, pw = _pooled(output_size)
    bidx = _batch_index("roi_align", rois_num, _shape0(rois),
                        _device_of(input))
    return apply("roi_align", _roi_align, input, rois, bidx=bidx, ph=ph,
                 pw=pw, spatial_scale=spatial_scale,
                 sampling_ratio=sampling_ratio, aligned=aligned)


def _shape0(t):
    return (t._data if hasattr(t, "_data") else t).shape[0]


def _device_of(t):
    return (t._data if hasattr(t, "_data") else t).device


def _roi_align(feat, boxes, bidx, ph, pw, spatial_scale, sampling_ratio,
               aligned):
    n_img, c, h, w = feat.shape
    r = boxes.shape[0]
    dt, dev = feat.dtype, feat.device
    b = boxes * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1 = b[:, 0], b[:, 1]
    rw, rh = b[:, 2] - x1, b[:, 3] - y1
    if not aligned:
        rw, rh = rw.clamp(min=1.0), rh.clamp(min=1.0)
    bin_w, bin_h = rw / pw, rh / ph
    if sampling_ratio > 0:
        g_y = g_x = int(sampling_ratio)
        gy = torch.full_like(bin_h, float(sampling_ratio))
        gx = torch.full_like(bin_w, float(sampling_ratio))
    else:
        g_y = min(8, max(1, int(np.ceil(h / ph))))
        g_x = min(8, max(1, int(np.ceil(w / pw))))
        gy = torch.ceil(bin_h).clamp(1, g_y)
        gx = torch.ceil(bin_w).clamp(1, g_x)
        if not capturing() and r:
            # taps past every roi's count add exact zeros: outside a
            # capture, run only the grid's used part
            g_y, g_x = int(gy.max()), int(gx.max())
    # rows of a channels-last copy of the input, [N * H * W, C]
    flat = feat.permute(0, 2, 3, 1).reshape(n_img * h * w, c)
    base = (bidx * (h * w))[:, None, None]
    ar_y = torch.arange(ph, device=dev)[None, :]
    ar_x = torch.arange(pw, device=dev)[None, :]
    zero = torch.zeros((), dtype=dt, device=dev)

    def axis_taps(s, g, lo, bin_, n_ar, size):
        """Tap ``s`` of every bin along one axis: corner indices
        ``[R, n]``, the upper corner's weight, and the in-range mask."""
        pos = lo[:, None] + bin_[:, None] * (n_ar + ((s + 0.5) / g)[:, None])
        ok = (pos >= -1) & (pos <= size)
        pos = pos.clamp(0.0, float(size - 1))
        p0 = torch.floor(pos)
        i0 = p0.to(torch.int64)
        return i0, (i0 + 1).clamp(0, size - 1), pos - p0, ok

    acc = torch.zeros((r, ph, pw, c), dtype=dt, device=dev)
    for sy in range(g_y):
        y0, y1i, wy, oky = axis_taps(sy, gy, y1, bin_h, ar_y, h)
        r0, r1 = base + y0[:, :, None] * w, base + y1i[:, :, None] * w
        wy_, my = wy[:, :, None], sy < gy
        for sx in range(g_x):
            x0, x1i, wx, okx = axis_taps(sx, gx, x1, bin_w, ar_x, w)
            wx_ = wx[:, None, :]
            x0, x1i = x0[:, None, :], x1i[:, None, :]
            idx = torch.stack([r0 + x0, r1 + x0, r0 + x1i, r1 + x1i])
            g = flat.index_select(0, idx.reshape(-1)).view(4, r, ph, pw, c)
            wts = torch.stack([(1 - wy_) * (1 - wx_), wy_ * (1 - wx_),
                               (1 - wy_) * wx_, wy_ * wx_])[..., None]
            v = (g[0] * wts[0] + g[1] * wts[1]) + g[2] * wts[2] + \
                g[3] * wts[3]                                # [R, ph, pw, C]
            take = (oky[:, :, None] & okx[:, None, :]
                    & (my & (sx < gx))[:, None, None])
            acc = acc + torch.where(take[..., None], v, zero)
    out = acc / (gy * gx)[:, None, None, None]
    return out.permute(0, 3, 1, 2)                           # [R, C, ph, pw]


def roi_pool(input, rois, output_size, spatial_scale=1.0, rois_num=None,
             name=None):
    """reference: operators/roi_pool_op.cc: the max over each bin of
    integer-quantized roi boundaries (empty bins 0). The rois go in
    chunks, the bins' max one bin column and row at a time, so the peak
    intermediate is a chunk of rois' ``[C, H, W]`` maps."""
    ph, pw = _pooled(output_size)
    bidx = _batch_index("roi_pool", rois_num, _shape0(rois),
                        _device_of(input))
    return apply("roi_pool", _roi_pool, input, rois, bidx=bidx, ph=ph,
                 pw=pw, spatial_scale=spatial_scale)


def _roi_pool(feat, boxes, bidx, ph, pw, spatial_scale):
    _, c, h, w = feat.shape
    dev = feat.device
    b = torch.round(boxes * spatial_scale)
    x1 = b[:, 0].clamp(0, w - 1).to(torch.int64)
    y1 = b[:, 1].clamp(0, h - 1).to(torch.int64)
    x2 = b[:, 2].clamp(0, w - 1).to(torch.int64)
    y2 = b[:, 3].clamp(0, h - 1).to(torch.int64)
    rh = (y2 - y1 + 1).clamp(min=1)
    rw = (x2 - x1 + 1).clamp(min=1)
    yy = torch.arange(h, device=dev)[None, :]
    xx = torch.arange(w, device=dev)[None, :]
    py = torch.div((yy - y1[:, None]) * ph, rh[:, None], rounding_mode="floor")
    px = torch.div((xx - x1[:, None]) * pw, rw[:, None], rounding_mode="floor")
    py = torch.where((yy >= y1[:, None]) & (yy < (y1 + rh)[:, None]), py, -1)
    px = torch.where((xx >= x1[:, None]) & (xx < (x1 + rw)[:, None]), px, -1)
    ninf = torch.full((), -float("inf"), dtype=feat.dtype, device=dev)
    outs = []
    for sl in _chunks(boxes.shape[0], c * h * w):
        img = feat[bidx[sl]]                                # [r, C, H, W]
        cols = torch.stack([torch.where(
            (px[sl] == j)[:, None, None, :], img, ninf).amax(dim=3)
            for j in range(pw)], dim=3)                    # [r, C, H, pw]
        out = torch.stack([torch.where(
            (py[sl] == i)[:, None, :, None], cols, ninf).amax(dim=2)
            for i in range(ph)], dim=2)                    # [r, C, ph, pw]
        outs.append(out)
    out = torch.cat(outs, 0)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def psroi_pool(x, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    """reference: operators/psroi_pool_op.cc:79 (R-FCN's position-
    sensitive average pooling), as the JAX package computes it: integer
    bin edges and a summed-area table of the input in float32, read at
    each roi's image (no ``[R, C, H+1, W+1]`` copy). Output ``[R,
    output_channels, ph, pw]``; empty bins 0."""
    bidx = _batch_index("psroi_pool", rois_num, _shape0(rois),
                        _device_of(x))
    return apply("psroi_pool", _psroi_pool, x, rois, bidx=bidx,
                 oc=int(output_channels), spatial_scale=spatial_scale,
                 ph=int(pooled_height), pw=int(pooled_width))


def _psroi_pool(feat, boxes, bidx, oc, spatial_scale, ph, pw):
    _, _, h, w = feat.shape
    dev = feat.device
    x1 = torch.round(boxes[:, 0]) * spatial_scale
    y1 = torch.round(boxes[:, 1]) * spatial_scale
    x2 = torch.round(boxes[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(boxes[:, 3] + 1.0) * spatial_scale
    bin_h = (y2 - y1).clamp(min=0.1) / ph
    bin_w = (x2 - x1).clamp(min=0.1) / pw
    iy = torch.arange(ph, dtype=feat.dtype, device=dev)[None, :]
    ix = torch.arange(pw, dtype=feat.dtype, device=dev)[None, :]

    def edges(i, bin_, lo, size):
        s = torch.floor(i * bin_[:, None] + lo[:, None]).clamp(0, size)
        e = torch.ceil((i + 1) * bin_[:, None] + lo[:, None]).clamp(0, size)
        return s.to(torch.int64), e.to(torch.int64)
    hs, he = edges(iy, bin_h, y1, h)                         # [R, ph]
    ws, we = edges(ix, bin_w, x1, w)                         # [R, pw]
    sat = torch.nn.functional.pad(torch.cumsum(torch.cumsum(
        feat.float(), dim=2), dim=3), (1, 0, 1, 0))         # [N, C, H1, W1]
    cin = ((torch.arange(oc, device=dev)[:, None, None] * ph
            + torch.arange(ph, device=dev)[None, :, None]) * pw
           + torch.arange(pw, device=dev)[None, None, :])  # [oc, ph, pw]
    bi, ci = bidx[:, None, None, None], cin[None]
    h0, h1 = hs[:, None, :, None], he[:, None, :, None]
    w0, w1 = ws[:, None, None, :], we[:, None, None, :]
    s = (sat[bi, ci, h1, w1] - sat[bi, ci, h0, w1]
         - sat[bi, ci, h1, w0] + sat[bi, ci, h0, w0])
    count = ((he - hs)[:, None, :, None]
             * (we - ws)[:, None, None, :]).float()
    out = torch.where(count > 0, s / count.clamp(min=1.0),
                      torch.zeros((), device=dev))
    return out.to(feat.dtype)


def _tri_integral(t):
    """The antiderivative of the triangle kernel ``max(0, 1-|s|)`` from
    -1 to ``t`` (piecewise quadratic)."""
    t = t.clamp(-1.0, 1.0)
    return torch.where(t <= 0, 0.5 * (t + 1.0) ** 2,
                       0.5 + t * (1.0 - 0.5 * t))


def prroi_pool(x, rois, pooled_height, pooled_width, spatial_scale=1.0,
               rois_num=None, name=None):
    """reference: operators/prroi_pool_op.cc (Precise RoI Pooling): each
    bin's exact integral of the bilinear surface over the continuous bin,
    divided by its area, as the JAX package factors it into per-axis
    triangle-kernel integrals and one contraction (rois in chunks)."""
    bidx = _batch_index("prroi_pool", rois_num, _shape0(rois),
                        _device_of(x))
    return apply("prroi_pool", _prroi_pool, x, rois, bidx=bidx,
                 ph=int(pooled_height), pw=int(pooled_width),
                 spatial_scale=spatial_scale)


def _prroi_pool(feat, boxes, bidx, ph, pw, spatial_scale):
    _, c, h, w = feat.shape
    dev = feat.device
    b = boxes.float() * spatial_scale
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bin_h, bin_w = (y2 - y1) / ph, (x2 - x1) / pw
    f32 = dict(dtype=torch.float32, device=dev)
    hs = y1[:, None] + torch.arange(ph, **f32)[None, :] * bin_h[:, None]
    ws = x1[:, None] + torch.arange(pw, **f32)[None, :] * bin_w[:, None]
    he, we = hs + bin_h[:, None], ws + bin_w[:, None]
    hh, ww = torch.arange(h, **f32), torch.arange(w, **f32)
    ih = (_tri_integral(he[:, :, None] - hh) - _tri_integral(
        hs[:, :, None] - hh))                               # [R, ph, H]
    iw = (_tri_integral(we[:, :, None] - ww) - _tri_integral(
        ws[:, :, None] - ww))                               # [R, pw, W]
    ff = feat.float()
    out = torch.cat([torch.einsum("rchw,rih,rjw->rcij", ff[bidx[sl]],
                                  ih[sl], iw[sl])
                     for sl in _chunks(boxes.shape[0], c * h * w)], 0)
    area = (bin_h * bin_w).clamp(min=1e-9)[:, None, None, None]
    return (out / area).to(feat.dtype)


def deformable_psroi_pooling(x, rois, trans, no_trans=False,
                             spatial_scale=1.0, group_size=1,
                             pooled_height=1, pooled_width=1, part_size=1,
                             sample_per_part=4, trans_std=0.1,
                             rois_num=None, name=None):
    """reference: operators/deformable_psroi_pooling_op.cc (Deformable
    R-FCN): position-sensitive RoI pooling whose bins move by
    ``trans * trans_std * roi extent`` of their part, each bin the mean
    of a ``sample_per_part`` x ``sample_per_part`` grid of bilinear taps
    inside the map. x ``[N, C, H, W]`` with ``C = oc * group^2``; trans
    ``[R, 2, part, part]``. Output ``[R, oc, ph, pw]``."""
    if no_trans and trans is None:
        trans = torch.zeros((1, 2, int(part_size), int(part_size)),
                            device=_device_of(x))
    bidx = _batch_index("deformable_psroi_pooling", rois_num, _shape0(rois),
                        _device_of(x))
    return apply("deformable_psroi_pooling", _deformable_psroi, x, rois,
                 trans, bidx=bidx, no_trans=no_trans,
                 spatial_scale=spatial_scale, gs=int(group_size),
                 ph=int(pooled_height), pw=int(pooled_width),
                 pt=int(part_size), sp=int(sample_per_part),
                 trans_std=trans_std)


def _deformable_psroi(feat, boxes, tr, bidx, no_trans, spatial_scale, gs, ph,
                      pw, pt, sp, trans_std):
    _, c, h, w = feat.shape
    oc = c // (gs * gs)
    r = boxes.shape[0]
    dev = feat.device
    b = boxes.float()
    x1 = torch.round(b[:, 0]) * spatial_scale - 0.5
    y1 = torch.round(b[:, 1]) * spatial_scale - 0.5
    x2 = (torch.round(b[:, 2]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(b[:, 3]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bin_h, bin_w = rh / ph, rw / pw
    sub_h, sub_w = bin_h / sp, bin_w / sp
    iy = torch.arange(ph, device=dev)
    ix = torch.arange(pw, device=dev)
    py = torch.div(iy * pt, ph, rounding_mode="floor").clamp(0, pt - 1)
    px = torch.div(ix * pt, pw, rounding_mode="floor").clamp(0, pt - 1)
    if no_trans:
        dy = torch.zeros((r, ph, pw), device=dev)
        dx = torch.zeros((r, ph, pw), device=dev)
    else:
        dy = tr[:, 0][:, py][:, :, px] * trans_std * rh[:, None, None]
        dx = tr[:, 1][:, py][:, :, px] * trans_std * rw[:, None, None]
    s = torch.arange(sp, dtype=torch.float32, device=dev)
    ty = (y1[:, None] + iy[None, :] * bin_h[:, None])[:, :, None] \
        + (s[None, None, :] + 0.5) * sub_h[:, None, None]
    tx = (x1[:, None] + ix[None, :] * bin_w[:, None])[:, :, None] \
        + (s[None, None, :] + 0.5) * sub_w[:, None, None]
    ty = (ty[:, :, None, :, None] + dy[:, :, :, None, None]).expand(
        r, ph, pw, sp, sp)
    tx = (tx[:, None, :, None, :] + dx[:, :, :, None, None]).expand(
        r, ph, pw, sp, sp)
    inside = (ty >= -0.5) & (ty <= h - 0.5) & (tx >= -0.5) & (tx <= w - 0.5)
    ty = ty.clamp(0.0, h - 1.0)
    tx = tx.clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(ty), torch.floor(tx)
    ay, ax = ty - y0, tx - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1i, x1i = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    gy = torch.div(iy * gs, ph, rounding_mode="floor").clamp(0, gs - 1)
    gx = torch.div(ix * gs, pw, rounding_mode="floor").clamp(0, gs - 1)
    cin = (torch.arange(oc, device=dev)[:, None, None] * gs
           + gy[None, :, None]) * gs + gx[None, None, :]     # [oc, ph, pw]
    bi = bidx[:, None, None, None, None, None]
    ci = cin[None, :, :, :, None, None]
    y_a, y_b, x_a, x_b = y0[:, None], y1i[:, None], x0[:, None], x1i[:, None]
    ay, ax = ay[:, None], ax[:, None]
    val = (feat[bi, ci, y_a, x_a] * ((1 - ay) * (1 - ax))
           + feat[bi, ci, y_a, x_b] * ((1 - ay) * ax)
           + feat[bi, ci, y_b, x_a] * (ay * (1 - ax))
           + feat[bi, ci, y_b, x_b] * (ay * ax))
    m = inside[:, None].to(val.dtype)
    cnt = m.sum(dim=(-1, -2)).clamp(min=1.0)
    return ((val * m).sum(dim=(-1, -2)) / cnt).to(feat.dtype)


# -- matching, assignment, losses -----------------------------------------------

def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """reference: detection/bipartite_match_op.cc: greedy bipartite
    matching on a ``[M, N]`` similarity matrix, ``min(M, N)`` steps each
    taking the largest entry left and retiring its row and column, on the
    device. Returns (match_indices ``[1, N]`` int32, match_dist
    ``[1, N]``); ``per_prediction`` with a threshold also matches every
    unmatched column to its best row at or above it."""
    return apply("bipartite_match", _bipartite_match, dist_matrix,
                 match_type=match_type, dist_threshold=dist_threshold)


def _bipartite_match(dm, match_type, dist_threshold):
    m, n = dm.shape[-2], dm.shape[-1]
    dev = dm.device
    ninf = torch.full((), -float("inf"), dtype=dm.dtype, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    row_ok = torch.ones(m, dtype=torch.bool, device=dev)
    col_ok = torch.ones(n, dtype=torch.bool, device=dev)
    match = torch.full((n,), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros(n, dtype=dm.dtype, device=dev)
    for _ in range(min(m, n)):
        flat = torch.where(row_ok[:, None] & col_ok[None, :], dm,
                           ninf).reshape(-1)
        best = torch.argmax(flat)
        r, c, v = best // n, best % n, flat[best]
        good = v > ninf
        row_ok = row_ok & ~((rows == r) & good)
        hit = (cols == c) & good
        col_ok = col_ok & ~hit
        match = torch.where(hit, r.to(torch.int32), match)
        mdist = torch.where(hit, v, mdist)
    if match_type == "per_prediction" and dist_threshold is not None:
        best_v, best_r = dm.max(dim=0)
        extra = (match < 0) & (best_v >= dist_threshold)
        match = torch.where(extra, best_r.to(torch.int32), match)
        mdist = torch.where(extra, best_v, mdist)
    return match[None, :], mdist[None, :]


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """reference: detection/target_assign_op.cc: ``out[i][j] =
    input[matched_indices[i][j]]`` (``mismatch_value`` where the index is
    negative) and weights 1 where matched, else 0 (float32)."""
    return apply("target_assign", _target_assign, input, matched_indices,
                 mismatch_value=mismatch_value)


def _target_assign(x, mi, mismatch_value):
    ok = mi >= 0
    g = x[mi.clamp(0, x.shape[0] - 1).to(torch.int64)]
    okx = ok.reshape(*ok.shape, *([1] * (g.dim() - ok.dim())))
    out = torch.where(okx, g, torch.full((), mismatch_value, dtype=g.dtype,
                                         device=g.device))
    return out, ok.to(torch.float32)


def polygon_box_transform(input, name=None):
    """reference: detection/polygon_box_transform_op.cc: offsets to
    absolute quad coordinates, ``4 * grid + input`` (even channels x, odd
    y)."""
    return apply("polygon_box_transform", _polygon_box_transform, input)


def _polygon_box_transform(x):
    _, c, h, w = x.shape
    dev = x.device
    gx = (torch.arange(w, device=dev)[None, :] * 4.0).expand(h, w)
    gy = (torch.arange(h, device=dev)[:, None] * 4.0).expand(h, w)
    even = (torch.arange(c, device=dev) % 2 == 0)[None, :, None, None]
    return torch.where(even, gx[None, None], gy[None, None]).to(x.dtype) + x


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None):
    """reference: operators/smooth_l1_loss_op.cc: the huberized
    difference with inside and outside weights, summed per row
    ``[N, 1]``."""
    return apply("smooth_l1", _smooth_l1, x, y, inside_weight,
                 outside_weight, s2=float(sigma) * float(sigma))


def _smooth_l1(a, b, iw, ow, s2):
    d = a - b
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    val = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ow is not None:
        val = val * ow
    return val.reshape(a.shape[0], -1).sum(dim=1, keepdim=True)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """reference: detection/matrix_nms_op.cc (SOLOv2's parallel soft
    NMS): each candidate's score decays by ``min_j f(iou_ij) /
    f(comp_j)`` over the higher-ranked ``j``, every class of every image
    at once. Fixed-size outputs as ``multiclass_nms``: out ``[N,
    keep_top_k, 6]``, index ``[N, keep_top_k]`` int32 (into the
    concatenated per-class candidates, with ``return_index``), counts
    ``[N]``."""
    out, idx, counts = apply(
        "matrix_nms", _matrix_nms, bboxes, scores,
        score_threshold=score_threshold, post_threshold=post_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        use_gaussian=use_gaussian, gaussian_sigma=gaussian_sigma,
        background_label=background_label, normalized=normalized)
    return (out, idx, counts) if return_index else (out, counts)


def _matrix_nms(bb, sc, score_threshold, post_threshold, nms_top_k,
                keep_top_k, use_gaussian, gaussian_sigma, background_label,
                normalized):
    top_s, labels, cand, iou = _class_candidates(
        bb, sc, min(int(nms_top_k), sc.shape[-1]), normalized,
        background_label)                      # [N, C', k], ..., [N,C',k,k]
    n, c_n, k = top_s.shape
    idx = torch.arange(k, device=sc.device)
    before = idx[:, None] < idx[None, :]          # [j, i]: j ranks above i
    zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
    iou_ji = torch.where(before, iou, zero)
    comp = torch.where(before.T, iou, zero).amax(dim=-1)    # [N, C', k]
    cj = comp[..., :, None]
    if use_gaussian:
        factor = torch.exp((cj * cj - iou_ji * iou_ji) / gaussian_sigma)
    else:
        factor = (1.0 - iou_ji) / (1.0 - cj)
    factor = torch.where(before, factor, torch.ones((), dtype=iou.dtype,
                                                   device=iou.device))
    dec = factor.amin(dim=-2)
    neg = torch.full((), -1.0, dtype=top_s.dtype, device=top_s.device)
    ds = torch.where(top_s > score_threshold, top_s * dec, neg)
    ds = torch.where(ds > post_threshold, ds, neg).reshape(n, c_n * k)
    all_labels = labels[:, None].expand(c_n, k).reshape(c_n * k)
    all_boxes = cand.reshape(n, c_n * k, 4)
    kk = min(int(keep_top_k), c_n * k)
    best, bi = _top_k(ds, kk)
    valid = best >= 0
    lab = torch.where(valid, all_labels[bi], neg)
    score = torch.where(valid, best, torch.zeros_like(best))
    box = torch.gather(all_boxes, 1, bi[..., None].expand(n, kk, 4))
    box = torch.where(valid[..., None], box, torch.zeros_like(box))
    out = torch.cat([lab[..., None], score[..., None], box], dim=-1)
    bi = bi.to(torch.int32)
    if kk < keep_top_k:
        pad = torch.zeros((n, keep_top_k - kk, 6), dtype=out.dtype,
                          device=out.device)
        pad[..., 0] = -1.0
        out = torch.cat([out, pad], dim=1)
        bi = torch.cat([bi, bi.new_zeros(n, keep_top_k - kk)], dim=1)
    return out, bi, valid.sum(dim=-1).to(torch.int32)
