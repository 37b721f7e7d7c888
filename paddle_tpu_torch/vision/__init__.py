"""Vision models of the port (counterpart of ``paddle_tpu/vision``; so
far the YOLOv3 detector and its DarkNet-53 backbone; transforms,
datasets and the other models are ROADMAP.md queue A9)."""
from . import models
from .models import (DarkNet, YOLOv3, YOLOv3Loss, darknet53,
                     yolov3_darknet53)

__all__ = ["models", "DarkNet", "YOLOv3", "YOLOv3Loss", "darknet53",
           "yolov3_darknet53"]
