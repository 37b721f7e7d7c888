"""paddle.vision.ops (counterpart of ``paddle_tpu/vision/ops.py``;
reference: python/paddle/vision/ops.py): ``yolo_loss``, ``yolo_box``,
``deform_conv2d`` and ``DeformConv2D`` over the port's detection and
convolution ops, with the reference's argument names, and ``read_file``
and ``decode_jpeg``."""
from __future__ import annotations

import torch

from ..core.device import DeviceLike, resolve_device
from ..nn import initializer as I
from ..nn.functional.conv import deformable_conv as _deform
from ..nn.layer_base import Layer
from ..nn.layers_common import _param, _reset
from ..ops.detection import yolo_box, yolov3_loss as _yolov3_loss
from .image import decode_jpeg, read_file

__all__ = ["yolo_loss", "yolo_box", "deform_conv2d", "DeformConv2D",
           "read_file", "decode_jpeg"]


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """reference: vision/ops.py:31, the fluid ``yolov3_loss`` op."""
    return _yolov3_loss(x, gt_box, gt_label, anchors=anchors,
                        anchor_mask=anchor_mask, class_num=class_num,
                        ignore_thresh=ignore_thresh,
                        downsample_ratio=downsample_ratio,
                        gt_score=gt_score,
                        use_label_smooth=use_label_smooth,
                        scale_x_y=scale_x_y)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """reference: vision/ops.py:397 (``mask=None`` is DCNv1, a mask
    DCNv2)."""
    return _deform(x, offset, weight, mask=mask, bias=bias, stride=stride,
                   padding=padding, dilation=dilation,
                   deformable_groups=deformable_groups, groups=groups)


class DeformConv2D(Layer):
    """reference: vision/ops.py:601, a layer over :func:`deform_conv2d`;
    weight ``[out, in/groups, kh, kw]`` Xavier-uniform, bias zeros, as the
    reference's ``create_parameter`` defaults."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        ks = (kernel_size if isinstance(kernel_size, (list, tuple))
              else (kernel_size, kernel_size))
        self._attrs = dict(stride=stride, padding=padding,
                           dilation=dilation,
                           deformable_groups=deformable_groups,
                           groups=groups)
        dev = resolve_device(device)
        _param(self, "weight", [out_channels, in_channels // groups, ks[0],
                                ks[1]], weight_attr, dev, dtype,
               I.XavierUniform())
        _param(self, "bias", [out_channels], bias_attr, dev, dtype,
               I.Constant(0.0))

    reset_parameters = _reset

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, bias=self.bias,
                             mask=mask, **self._attrs)
