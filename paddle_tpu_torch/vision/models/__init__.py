"""Model zoo of the port (counterpart of ``paddle_tpu/vision/models``:
LeNet, the ResNet and VGG families, DarkNet-53 and YOLOv3 so far;
MobileNet is ROADMAP.md queue A9)."""
from .darknet import DarkNet, darknet53
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .yolov3 import YOLOv3, YOLOv3Loss, yolov3_darknet53

__all__ = ["DarkNet", "darknet53", "LeNet", "BasicBlock", "BottleneckBlock",
           "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2", "VGG",
           "vgg11", "vgg13", "vgg16", "vgg19", "YOLOv3", "YOLOv3Loss",
           "yolov3_darknet53"]
