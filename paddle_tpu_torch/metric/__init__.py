"""paddle.metric (counterpart of ``paddle_tpu/metric/__init__.py:15-304``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc``,
``DetectionMAP`` and the functional ``accuracy``.

``Accuracy.compute`` is the on-device step, as the reference's docstring
names it: ``torch.topk`` on the predictions' device, and only the
``[N, maxk]`` hit mask goes to the host (the reference sorts the whole
``[N, classes]`` logits with NumPy). It counts as the reference does:
``c.shape[0]`` rows per update, so for 3-D predictions the hits over
every position are divided by the batch. With tied logits the order
among ties may differ from NumPy's sort; with distinct logits the two
agree. The other metrics keep their state on the host, as the
reference's do, and take tensors on any device or arrays.
"""
from __future__ import annotations

import sys as _sys

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc",
           "DetectionMAP", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Pre-processing on the predictions' device; passthrough by
        default."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference ``:36``)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    @torch.no_grad()
    def compute(self, pred, label, *args):
        """The ``[..., maxk]`` float32 mask of the top-k hits, as a host
        array; labels may be indices, ``[N, 1]`` or one-hot."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        if label.ndim == pred.ndim:        # one-hot or [N, 1]
            if label.shape[-1] == pred.shape[-1]:
                label = label.argmax(-1)
            else:
                label = label.squeeze(-1)
        k = min(self.maxk, pred.shape[-1])
        idx = torch.topk(pred, k, dim=-1).indices
        return (idx == label.unsqueeze(-1)).float().cpu().numpy()

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0] if c.ndim > 1 else len(c)
        res = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            res.append(num / max(n, 1))
        return np.asarray(res[0] if len(res) == 1 else res)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision at 0.5 (reference ``:82``)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall at 0.5 (reference ``:108``)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


def _trapezoid(y, x):
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x)


class Auc(Metric):
    """Threshold-bucketed ROC AUC (reference ``:132``)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = _np(labels).reshape(-1)
        buckets = np.minimum((p * self.num_thresholds).astype(np.int64),
                             self.num_thresholds)
        n = self.num_thresholds + 1
        pos = lab.astype(bool)
        self._stat_pos += np.bincount(buckets[pos], minlength=n)
        self._stat_neg += np.bincount(buckets[~pos], minlength=n)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over cumulative TPR/FPR from high threshold to low
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


@torch.no_grad()
def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top ``k`` (reference
    ``:175``), a float32 scalar tensor on ``input``'s device."""
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device).reshape(-1, 1)
    idx = torch.topk(input, min(k, input.shape[-1]), dim=-1).indices
    return (idx == label).any(-1).float().mean()


class DetectionMAP(Metric):
    """VOC-style detection mAP (reference ``:186``), on the host:
    ``update(dets [N, K, 6] rows (label, score, x1, y1, x2, y2) padded
    with label -1, counts [N], gt_box [N, B, 4] xyxy zero-padded,
    gt_label [N, B], difficult [N, B] or None)``; ``ap_version``
    ``"integral"`` or ``"11point"``."""

    def __init__(self, class_num, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral",
                 name="mAP"):
        super().__init__()
        if ap_version not in ("integral", "11point"):
            raise ValueError(f"ap_version {ap_version!r} not in "
                             "('integral', '11point')")
        self.class_num = int(class_num)
        self.thresh = float(overlap_threshold)
        self.eval_difficult = bool(evaluate_difficult)
        self.ap_version = ap_version
        self._name = name
        self.reset()

    def reset(self):
        # per class: list of (score, is_tp); gt count excl. difficult
        self._scores = [[] for _ in range(self.class_num)]
        self._npos = np.zeros(self.class_num, np.int64)

    @staticmethod
    def _iou(box, gts):
        ix1 = np.maximum(box[0], gts[:, 0])
        iy1 = np.maximum(box[1], gts[:, 1])
        ix2 = np.minimum(box[2], gts[:, 2])
        iy2 = np.minimum(box[3], gts[:, 3])
        iw = np.maximum(ix2 - ix1, 0)
        ih = np.maximum(iy2 - iy1, 0)
        inter = iw * ih
        a1 = (box[2] - box[0]) * (box[3] - box[1])
        a2 = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
        return inter / np.maximum(a1 + a2 - inter, 1e-10)

    def update(self, dets, counts, gt_box, gt_label, difficult=None):
        dets, counts = _np(dets), _np(counts).astype(np.int64)
        gt_box, gt_label = _np(gt_box), _np(gt_label).astype(np.int64)
        difficult = (np.zeros_like(gt_label) if difficult is None
                     else _np(difficult).astype(np.int64))
        for n in range(dets.shape[0]):
            valid_gt = (gt_box[n, :, 2] > gt_box[n, :, 0]) & \
                       (gt_box[n, :, 3] > gt_box[n, :, 1])
            g_box = gt_box[n][valid_gt]
            g_lab = gt_label[n][valid_gt]
            g_dif = difficult[n][valid_gt]
            for c in range(self.class_num):
                self._npos[c] += int(((g_lab == c) & ((g_dif == 0) |
                                      self.eval_difficult)).sum())
            d = dets[n, :counts[n]]
            d = d[d[:, 0] >= 0]
            order = np.argsort(-d[:, 1], kind="stable")
            matched = np.zeros(len(g_box), bool)
            for row in d[order]:
                c = int(row[0])
                if not (0 <= c < self.class_num):
                    continue
                cand = np.where(g_lab == c)[0]
                if cand.size == 0:
                    self._scores[c].append((row[1], 0))
                    continue
                ious = self._iou(row[2:6], g_box[cand])
                j = int(np.argmax(ious))
                gi = cand[j]
                if ious[j] >= self.thresh:
                    if g_dif[gi] and not self.eval_difficult:
                        continue            # difficult match: ignore det
                    if not matched[gi]:
                        matched[gi] = True
                        self._scores[c].append((row[1], 1))
                    else:
                        self._scores[c].append((row[1], 0))
                else:
                    self._scores[c].append((row[1], 0))

    def accumulate(self):
        aps = []
        for c in range(self.class_num):
            if self._npos[c] == 0:
                continue
            if not self._scores[c]:
                aps.append(0.0)
                continue
            rec = np.asarray(self._scores[c], np.float64)
            order = np.argsort(-rec[:, 0], kind="stable")
            tp = np.cumsum(rec[order, 1])
            fp = np.cumsum(1 - rec[order, 1])
            recall = tp / self._npos[c]
            precision = tp / np.maximum(tp + fp, 1e-10)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    mask = recall >= t
                    ap += (precision[mask].max() if mask.any() else 0.0) / 11
            else:
                # integral AP: sum precision deltas at each new recall level
                mrec = np.concatenate([[0], recall])
                ap = float(np.sum((mrec[1:] - mrec[:-1]) * precision))
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0

    def name(self):
        return self._name


# the reference exports ``paddle.metric.metrics`` (the defining submodule)
metrics = _sys.modules[__name__]
