"""Vision models of the port (counterpart of ``paddle_tpu/vision``; so
far the model zoo's LeNet, ResNet, VGG, DarkNet-53 and YOLOv3;
transforms, datasets and the other models are ROADMAP.md queue A9)."""
from . import models
from .models import (DarkNet, YOLOv3, YOLOv3Loss, darknet53,
                     yolov3_darknet53)

__all__ = ["models", "DarkNet", "YOLOv3", "YOLOv3Loss", "darknet53",
           "yolov3_darknet53"]
