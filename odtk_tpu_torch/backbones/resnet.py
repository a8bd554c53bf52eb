"""ResNet / ResNeXt feature extractors (NCHW): their FPN and C4
registrations.

Counterpart of ``odtk_tpu/backbones/resnet.py``. Module names follow
torchvision's state_dict keys (conv1, bn1, layer{1-4}.{i}.conv{j}/bn{j}/
downsample.{0,1}), so checkpoints written by the JAX package load with
``strict=True``. The stem is ``conv1`` (7x7/s2) followed by the fused
BN + ReLU + max-pool kernel of ``ops/kernels/stem.py``: the primal kernel
without autograd, the argmax forward and routing backward when grad is
enabled (``conv1`` trains through it).
"""

import torch
from torch import nn

from ..ops.kernels.stem import bn_relu_pool, bn_relu_pool_train
from .fpn import FPN
from .layers import FixedBatchNorm
from .registry import register


def _conv(cin, cout, kernel, stride=1, groups=1):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 width_per_group=64):
        super().__init__()
        del groups, width_per_group
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = FixedBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FixedBatchNorm(planes)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride),
                                         FixedBatchNorm(planes))
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, groups=1,
                 width_per_group=64):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = FixedBatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = FixedBatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = FixedBatchNorm(out_ch)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(_conv(cin, out_ch, 1, stride),
                                         FixedBatchNorm(out_ch))
                           if downsample else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """Returns the feature maps of the levels in ``outputs`` (level l at
    stride 2^l: the default C3, C4, C5 at strides 8, 16, 32) of an NCHW
    image batch. No stage beyond ``max(outputs)`` is built, so a C4 net
    has no ``layer4`` (``odtk_tpu/backbones/resnet.py:159-161,184``)."""

    def __init__(self, layers=(3, 4, 6, 3), bottleneck=True, groups=1,
                 width_per_group=64, outputs=(3, 4, 5)):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.outputs = tuple(outputs)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FixedBatchNorm(64)
        cin = 64
        self.stages = []
        for stage, blocks in enumerate(layers):
            if stage + 2 > max(self.outputs):
                break
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            seq = []
            for i in range(blocks):
                needs_ds = i == 0 and (stride != 1
                                       or cin != planes * block.expansion)
                seq.append(block(cin, planes, stride if i == 0 else 1,
                                 needs_ds, groups, width_per_group))
                cin = planes * block.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*seq))
            self.stages.append(f'layer{stage + 1}')
        self.feature_channels = [64 * 2 ** (level - 2) * block.expansion
                                 for level in self.outputs]

    def forward(self, x):
        scale, shift = self.bn1.fold()
        pool = bn_relu_pool_train if torch.is_grad_enabled() else bn_relu_pool
        x = pool(self.conv1(x), scale, shift)
        outs = []
        for level, name in enumerate(self.stages, start=2):
            x = getattr(self, name)(x)
            if level in self.outputs:
                outs.append(x)
        return outs


@register
def ResNet18FPN():
    return FPN(ResNet(layers=(2, 2, 2, 2), bottleneck=False))


@register
def ResNet34FPN():
    return FPN(ResNet(layers=(3, 4, 6, 3), bottleneck=False))


@register
def ResNet50FPN():
    return FPN(ResNet(layers=(3, 4, 6, 3)))


@register
def ResNet101FPN():
    return FPN(ResNet(layers=(3, 4, 23, 3)))


@register
def ResNet152FPN():
    return FPN(ResNet(layers=(3, 8, 36, 3)))


@register
def ResNeXt50_32x4dFPN():
    return FPN(ResNet(layers=(3, 4, 6, 3), groups=32, width_per_group=4))


@register
def ResNeXt101_32x8dFPN():
    return FPN(ResNet(layers=(3, 4, 23, 3), groups=32, width_per_group=8))


class ResNetC4(nn.Module):
    """Single-level C4 backbone (``odtk_tpu/backbones/resnet.py:256-288``):
    a BasicBlock ResNet through layer3 under ``features``, returning one
    level, layer3's output (stride 16, 256 channels)."""

    def __init__(self, layers):
        super().__init__()
        self.features = ResNet(layers=layers, bottleneck=False, outputs=(4,))

    def forward(self, x):
        return self.features(x)


@register
def ResNet18C4():
    return ResNetC4(layers=(2, 2, 2, 2))


@register
def ResNet34C4():
    return ResNetC4(layers=(3, 4, 6, 3))
