"""ResNet / ResNeXt feature extractors (NCHW) and their FPN registrations.

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
    """Returns the C3, C4, C5 feature maps (strides 8, 16, 32) of an NCHW
    image batch."""

    def __init__(self, layers=(3, 4, 6, 3), bottleneck=True, groups=1,
                 width_per_group=64):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FixedBatchNorm(64)
        cin = 64
        for stage, blocks in enumerate(layers):
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
        mult = block.expansion
        self.feature_channels = [128 * mult, 256 * mult, 512 * mult]

    def forward(self, x):
        scale, shift = self.bn1.fold()
        pool = bn_relu_pool_train if torch.is_grad_enabled() else bn_relu_pool
        x = pool(self.conv1(x), scale, shift)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return [c3, c4, c5]


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
