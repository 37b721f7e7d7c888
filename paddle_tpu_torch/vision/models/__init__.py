"""Model zoo of the port (counterpart of ``paddle_tpu/vision/models``:
DarkNet-53 and YOLOv3 so far)."""
from .darknet import BasicBlock, ConvBNLayer, DarkNet, darknet53
from .yolov3 import YOLOv3, YOLOv3Loss, yolov3_darknet53

__all__ = ["BasicBlock", "ConvBNLayer", "DarkNet", "darknet53", "YOLOv3",
           "YOLOv3Loss", "yolov3_darknet53"]
