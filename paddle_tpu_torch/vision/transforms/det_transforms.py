"""Detection transforms (counterpart of
``paddle_tpu/vision/transforms/det_transforms.py``; reference capability:
PaddleDetection's ppdet/data/transform/operators.py): ``DetCompose``,
``ResizeImage``, ``RandomFlipImage``, ``NormalizeBox``,
``BoxXYXY2XYWH``, ``PadBox``, ``NormalizeImage`` and ``Permute`` over
``(img, gt_box, gt_label, difficult)`` tuples, with static output
shapes (``PadBox`` fixes the box count, ``ResizeImage`` the size).

NumPy only. ``ResizeImage`` resizes bilinearly through PIL where PIL is
installed and by nearest-neighbour NumPy indexing where it is not (the
machine with the card has no PIL), as the JAX package does; the branch
that ran is in its ``backend`` attribute (``"pil"`` or ``"numpy"``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["DetCompose", "ResizeImage", "RandomFlipImage", "NormalizeBox",
           "BoxXYXY2XYWH", "PadBox", "NormalizeImage", "Permute"]


class DetCompose:
    """Compose over (img, gt_box, gt_label, difficult) tuples."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class ResizeImage:
    """Resize image to ``(target, target)`` and scale pixel boxes with it
    (ppdet ResizeImage with interp=bilinear, no keep-ratio — YOLO uses
    square inputs)."""

    def __init__(self, target_size=608):
        self.target = int(target_size)
        self.backend = None     # "pil" or "numpy" once it has run

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        h, w = img.shape[:2]
        t = self.target
        try:
            from PIL import Image
        except ImportError:
            Image = None
        if Image is not None:
            self.backend = "pil"
            im = Image.fromarray(np.asarray(img).astype(np.uint8))
            img2 = np.asarray(im.resize((t, t), Image.BILINEAR))
        else:
            self.backend = "numpy"
            yi = (np.arange(t) * (h / t)).astype(np.int64).clip(0, h - 1)
            xi = (np.arange(t) * (w / t)).astype(np.int64).clip(0, w - 1)
            img2 = np.asarray(img)[yi][:, xi]
        if boxes.size:
            boxes = boxes * np.array([t / w, t / h, t / w, t / h],
                                     np.float32)
        return img2, boxes, labels, difficult


class RandomFlipImage:
    """Horizontal flip with box mirror (ppdet RandomFlipImage)."""

    def __init__(self, prob=0.5, rng=None):
        self.prob = prob
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        if self.rng.rand() < self.prob:
            w = img.shape[1]
            img = np.ascontiguousarray(img[:, ::-1])
            if boxes.size:
                x1 = boxes[:, 0].copy()
                boxes = boxes.copy()
                boxes[:, 0] = w - boxes[:, 2]
                boxes[:, 2] = w - x1
        return img, boxes, labels, difficult


class NormalizeBox:
    """Pixel xyxy -> [0,1] xyxy (ppdet NormalizeBox)."""

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        h, w = img.shape[:2]
        if boxes.size:
            boxes = boxes / np.array([w, h, w, h], np.float32)
        return img, boxes, labels, difficult


class BoxXYXY2XYWH:
    """xyxy -> center xywh (ppdet BboxXYXY2XYWH) — the yolov3_loss gt
    format."""

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        if boxes.size:
            wh = boxes[:, 2:4] - boxes[:, 0:2]
            ctr = boxes[:, 0:2] + wh / 2
            boxes = np.concatenate([ctr, wh], axis=1)
        return img, boxes, labels, difficult


class PadBox:
    """Zero-pad/truncate boxes to a fixed count (ppdet PadBox) — the
    static-shape contract yolov3_loss relies on (w==h==0 marks an empty
    slot)."""

    def __init__(self, num_max_boxes=50):
        self.num = int(num_max_boxes)

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        m = min(len(boxes), self.num)
        out_b = np.zeros((self.num, 4), np.float32)
        out_l = np.zeros((self.num,), np.int64)
        out_d = np.zeros((self.num,), np.int64)
        if m:
            out_b[:m] = boxes[:m]
            out_l[:m] = labels[:m]
            out_d[:m] = difficult[:m]
        return img, out_b, out_l, out_d


class NormalizeImage:
    """uint8 HWC -> float32, /255, mean/std (ppdet NormalizeImage)."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 is_scale=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.is_scale = is_scale

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        img = np.asarray(img, np.float32)
        if self.is_scale:
            img = img / 255.0
        img = (img - self.mean) / self.std
        return img, boxes, labels, difficult


class Permute:
    """HWC -> CHW (ppdet Permute)."""

    def __call__(self, sample):
        img, boxes, labels, difficult = sample
        return (np.ascontiguousarray(np.transpose(img, (2, 0, 1))),
                boxes, labels, difficult)
