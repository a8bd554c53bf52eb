"""Backbones, registered by name: the ResNet / ResNeXt FPN family,
MobileNetV2FPN and the single-level ResNet18C4 / ResNet34C4
(``odtk_tpu/backbones/__init__.py``)."""

from . import fpn  # noqa: F401  (registers MobileNetV2FPN)
from . import resnet  # noqa: F401  (registers the ResNet FPN and C4 nets)
from .registry import available, build

__all__ = ['available', 'build']
