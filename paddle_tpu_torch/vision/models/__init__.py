"""Vision model zoo of the port (ports ``paddle_tpu/vision/models/``):
LeNet and the ResNet family.  VGG, MobileNet, AlexNet, DenseNet,
SqueezeNet, ShuffleNet and GoogLeNet wait (ROADMAP queue 1 item 5.9)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    wide_resnet50_2, wide_resnet101_2, resnext50_32x4d, resnext101_64x4d)
