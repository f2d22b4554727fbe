"""Model modules: backbones, recurrent heads, policy and the GFV composition."""

from adafocus_torch.models.gru import GRUCell
from adafocus_torch.models.mobilenet import MobileNetV2
from adafocus_torch.models.resnet import (
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152, wide_resnet101,
)

__all__ = [
    "GRUCell",
    "MobileNetV2",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "wide_resnet101",
]
