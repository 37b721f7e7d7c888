"""YOLOv3 detector (counterpart of ``paddle_tpu/vision/models/yolov3.py``:
``YOLOv3`` with ``forward``, ``loss`` and ``decode``, ``YOLOv3Loss`` and
``yolov3_darknet53``).

DarkNet-53 backbone, a 3-scale FPN head (C5 -> C4 -> C3 through 1x1
route convs and nearest 2x upsampling) and raw per-scale outputs
``[N, A*(5+C), S/ds, S/ds]`` for ds = 32, 16, 8. ``decode`` runs
``yolo_box`` on each scale and one ``multiclass_nms`` with a fixed
``keep_top_k`` output; its greedy scan runs on the NMS kernel
(``csrc/greedy_nms.cu``) on the card. Parameter names match the JAX
package 1:1 (``backbone.*``, ``yolo_block{i}.*``, ``yolo_out{i}.*``,
``route{i}.*``). ``loss`` and ``YOLOv3Loss`` sum the three scales'
batch means of ``yolov3_loss``; ``YOLOv3Loss`` is the loss a ``Model``
trains the detector with (``Model.prepare(opt, YOLOv3Loss(net))``, then
``train_batch([img], [gt_box, gt_label])``), one compiled step per
input size.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import amp
from ...core.device import DeviceLike, resolve_device
from ...nn import Conv2D, Upsample
from ...nn.layers_common import reset_parameters
from ...ops.detection import multiclass_nms, yolo_box, yolov3_loss
from .darknet import ConvBNLayer, DarkNet

__all__ = ["YOLOv3", "YOLOv3Loss", "yolov3_darknet53"]

# COCO anchor table (YOLOv3 paper); PaddleDetection yolov3 defaults
DEFAULT_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                   116, 90, 156, 198, 373, 326]
DEFAULT_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


def _scales_loss(outputs, gt_box, gt_label, anchors, anchor_masks,
                 num_classes, ignore_thresh, downsamples, gt_score=None):
    """Sum over the scales of the batch mean of ``yolov3_loss`` (the
    mean is op ``reduce_mean`` under AMP, as ``ops.mean``)."""
    total = None
    for out, mask, ds in zip(outputs, anchor_masks, downsamples):
        (per_img,) = amp.cast_inputs("reduce_mean", yolov3_loss(
            out, gt_box, gt_label, anchors=anchors, anchor_mask=mask,
            class_num=num_classes, ignore_thresh=ignore_thresh,
            downsample_ratio=ds, gt_score=gt_score))
        loss = torch.mean(per_img)
        total = loss if total is None else total + loss
    return total


class YoloDetBlock(nn.Module):
    """Five alternating 1x1/3x3 convs + the 3x3 'tip' (YOLOv3 fig. 3)."""

    def __init__(self, in_ch, channel, *, device: DeviceLike = None):
        super().__init__()
        self.conv0 = ConvBNLayer(in_ch, channel, kernel=1, device=device)
        self.conv1 = ConvBNLayer(channel, channel * 2, kernel=3,
                                 device=device)
        self.conv2 = ConvBNLayer(channel * 2, channel, kernel=1,
                                 device=device)
        self.conv3 = ConvBNLayer(channel, channel * 2, kernel=3,
                                 device=device)
        self.route = ConvBNLayer(channel * 2, channel, kernel=1,
                                 device=device)
        self.tip = ConvBNLayer(channel, channel * 2, kernel=3, device=device)

    def forward(self, x):
        r = self.route(self.conv3(self.conv2(self.conv1(self.conv0(x)))))
        return r, self.tip(r)


class YOLOv3(nn.Module):
    """Backbone + 3-scale FPN head + raw per-scale outputs.

    forward(img ``[N, 3, S, S]``) -> [out_32, out_16, out_8], each
    ``[N, A*(5+C), S/ds, S/ds]``. Parameters are drawn on ``device``
    from a generator seeded with ``seed``."""

    def __init__(self, num_classes=80, backbone=None, anchors=None,
                 anchor_masks=None, ignore_thresh=0.7, width_mult=1.0,
                 num_max_boxes=50, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = int(num_classes)
        self.anchors = list(anchors or DEFAULT_ANCHORS)
        self.anchor_masks = [list(m) for m in
                             (anchor_masks or DEFAULT_ANCHOR_MASKS)]
        self.ignore_thresh = float(ignore_thresh)
        self.num_max_boxes = int(num_max_boxes)
        self.backbone = backbone if backbone is not None else DarkNet(
            depth=53, width_mult=width_mult, device=dev, seed=None)
        self.downsamples = [32, 16, 8]

        in_chs = list(reversed(self.backbone.out_channels))  # C5, C4, C3
        self.blocks, self.outs, self.routes = [], [], []
        ch = None
        for i, in_ch in enumerate(in_chs):
            channel = max(int(512 * width_mult) // (2 ** i), 8)
            total_in = in_ch + (ch if i else 0)
            block = YoloDetBlock(total_in, channel, device=dev)
            a = len(self.anchor_masks[i])
            out_conv = Conv2D(channel * 2, a * (5 + self.num_classes), 1,
                              device=dev)
            self.add_module(f"yolo_block{i}", block)
            self.add_module(f"yolo_out{i}", out_conv)
            self.blocks.append(block)
            self.outs.append(out_conv)
            if i < len(in_chs) - 1:
                route = ConvBNLayer(channel, channel // 2, kernel=1,
                                    device=dev)
                self.add_module(f"route{i}", route)
                self.routes.append(route)
                ch = channel // 2
        self.upsample = Upsample(scale_factor=2, mode="nearest")
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        reset_parameters(self, gen)

    def forward(self, x):
        feats = self.backbone(x)            # [C3, C4, C5]
        outs = []
        route = None
        for i, feat in enumerate(reversed(feats)):   # C5 -> C3
            if i:
                feat = torch.cat([route, feat], dim=1)
            r, tip = self.blocks[i](feat)
            outs.append(self.outs[i](tip))
            if i < len(self.blocks) - 1:
                route = self.upsample(self.routes[i](r))
        return outs

    def loss(self, outputs, gt_box, gt_label, gt_score=None):
        """Sum of the three per-scale ``yolov3_loss`` terms, each meaned
        over the batch."""
        return _scales_loss(outputs, gt_box, gt_label, self.anchors,
                            self.anchor_masks, self.num_classes,
                            self.ignore_thresh, self.downsamples, gt_score)

    def decode(self, outputs, img_size, conf_thresh=0.01, nms_thresh=0.45,
               keep_top_k=100, nms_top_k=400):
        """yolo_box per scale + one multiclass NMS. Returns (dets
        ``[N, keep_top_k, 6]`` rows (label, score, x1, y1, x2, y2) padded
        with label -1, int32 counts ``[N]``)."""
        boxes, scores = [], []
        for out, mask, ds in zip(outputs, self.anchor_masks,
                                 self.downsamples):
            anchors = []
            for i in mask:
                anchors += [self.anchors[2 * i], self.anchors[2 * i + 1]]
            b, s = yolo_box(out, img_size, anchors=anchors,
                            class_num=self.num_classes,
                            conf_thresh=conf_thresh, downsample_ratio=ds)
            boxes.append(b)
            scores.append(s.transpose(1, 2))
        all_boxes = torch.cat(boxes, dim=1)        # [N, M, 4]
        all_scores = torch.cat(scores, dim=2)      # [N, C, M]
        return multiclass_nms(
            all_boxes, all_scores, score_threshold=conf_thresh,
            nms_top_k=nms_top_k, keep_top_k=keep_top_k,
            nms_threshold=nms_thresh, background_label=-1)


class YOLOv3Loss(nn.Module):
    """The ``Model`` loss head: ``loss(out32, out16, out8, gt_box,
    gt_label)``, the detector's anchors, classes and ignore threshold
    read at construction."""

    def __init__(self, model: YOLOv3):
        super().__init__()
        self._cfg = dict(anchors=model.anchors,
                         anchor_masks=model.anchor_masks,
                         num_classes=model.num_classes,
                         ignore_thresh=model.ignore_thresh,
                         downsamples=model.downsamples)

    def forward(self, out32, out16, out8, gt_box, gt_label):
        return _scales_loss([out32, out16, out8], gt_box, gt_label,
                            **self._cfg)


def yolov3_darknet53(num_classes=80, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("yolov3_darknet53: no bundled weights; load a "
                         "paddle.save file with framework_io.load instead")
    return YOLOv3(num_classes=num_classes, **kwargs)
