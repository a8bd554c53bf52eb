"""MobileNetV2 feature extractor (NCHW).

Counterpart of ``odtk_tpu/backbones/mobilenet.py``: a 3x3/s2
ConvBNReLU6 stem and 17 inverted residuals, tapped after blocks 6, 13
and 17 (strides 8, 16, 32; channels 32, 96, 320). Module names follow
torchvision's state_dict keys (``features.{i}.conv.{j}.{0,1}`` for a
ConvBNReLU6, ``features.{i}.conv.{j}`` / ``.{j+1}`` for the projection
conv and its batch norm, ``features.0.{0,1}`` for the stem), which are
the JAX package's flax paths split by ``io/jax_bridge.py``, so its
checkpoints load with ``strict=True``. Depthwise convolutions are
``nn.Conv2d`` with ``groups`` equal to their channels. The stem runs no
stem kernel: it is a plain convolution, batch norm and ReLU6.
"""

import torch
from torch import nn

from .layers import FixedBatchNorm

# (expand_ratio, out_channels, stride) of torchvision's features[1..17]
_IR_CFG = [
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),
    (6, 160, 2), (6, 160, 1), (6, 160, 1),
    (6, 320, 1),
]
# the blocks whose outputs are returned (strides 8, 16, 32)
_TAPS = (6, 13, 17)


class ReLU6(nn.Module):
    """min(relu(x), 6), as the JAX package computes it."""

    def forward(self, x):
        return torch.clamp(torch.relu(x), max=6.0)


def _conv_bn_relu6(cin, cout, kernel, stride=1, groups=1):
    """ConvBNReLU: indices 0 (conv) and 1 (batch norm)."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  groups=groups, bias=False),
        FixedBatchNorm(cout), ReLU6())


class InvertedResidual(nn.Module):
    """1x1 expansion (when ``expand != 1``), 3x3 depthwise, 1x1 linear
    projection and its batch norm, all under ``conv``; the residual when
    ``stride == 1`` and the widths agree."""

    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        layers = [_conv_bn_relu6(cin, hidden, 1)] if expand != 1 else []
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False),
                   FixedBatchNorm(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        out = self.conv(x)
        return out + x if self.residual else out


class MobileNet(nn.Module):
    """Returns the feature maps after the blocks in ``_TAPS``."""

    feature_channels = [32, 96, 320]

    def __init__(self):
        super().__init__()
        blocks, cin = [_conv_bn_relu6(3, 32, 3, 2)], 32
        for expand, cout, stride in _IR_CFG:
            blocks.append(InvertedResidual(cin, cout, stride, expand))
            cin = cout
        self.features = nn.Sequential(*blocks)

    def forward(self, x):
        outs = []
        for i, block in enumerate(self.features):
            x = block(x)
            if i in _TAPS:
                outs.append(x)
        return outs
