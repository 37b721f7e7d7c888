"""paddle.vision of the port (counterpart of ``paddle_tpu/vision``): the
model zoo (LeNet, the ResNet, VGG and MobileNet families, DarkNet-53,
YOLOv3), ``transforms`` (NumPy, for loader workers), ``datasets`` (local
files), ``ops`` and the image IO functions, and the image backend
switch."""
from . import datasets, models, ops, transforms
from .image import decode_jpeg, image_decode, image_load, read_file
from .models import (VGG, DarkNet, LeNet, MobileNetV1, MobileNetV2, ResNet,
                     YOLOv3, YOLOv3Loss, darknet53, mobilenet_v1,
                     mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     vgg11, vgg13, vgg16, vgg19, yolov3_darknet53)

__all__ = ["models", "transforms", "datasets", "ops", "LeNet", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
           "MobileNetV2", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_large", "mobilenet_v3_small", "image_load",
           "image_decode", "read_file", "decode_jpeg", "set_image_backend",
           "get_image_backend", "DarkNet", "YOLOv3", "YOLOv3Loss",
           "darknet53", "yolov3_darknet53"]


def set_image_backend(backend):
    """reference: vision/image.py set_image_backend: NumPy is the only
    backend here (PIL and cv2 both feed NumPy arrays)."""
    if backend not in ("pil", "cv2", "numpy", "tensor"):
        raise ValueError(f"unknown image backend {backend}")


def get_image_backend():
    return "numpy"
