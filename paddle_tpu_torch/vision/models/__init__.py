"""Model zoo of the port (counterpart of ``paddle_tpu/vision/models``:
LeNet, the ResNet, VGG and MobileNet families, DarkNet-53 and
YOLOv3)."""
from .darknet import DarkNet, darknet53
from .lenet import LeNet
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Large,
                        MobileNetV3Small, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .yolov3 import YOLOv3, YOLOv3Loss, yolov3_darknet53

__all__ = ["DarkNet", "darknet53", "LeNet", "BasicBlock", "BottleneckBlock",
           "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2", "VGG",
           "vgg11", "vgg13", "vgg16", "vgg19", "YOLOv3", "YOLOv3Loss",
           "yolov3_darknet53", "MobileNetV1", "MobileNetV2",
           "MobileNetV3Large", "MobileNetV3Small", "mobilenet_v1",
           "mobilenet_v2", "mobilenet_v3_large", "mobilenet_v3_small"]
