"""Feature Pyramid Network over a 3-level backbone (NCHW), and the
MobileNetV2FPN registration.

Counterpart of ``odtk_tpu/backbones/fpn.py:FPN``: 1x1 laterals on
C3/C4/C5, nearest x2 top-down additions, 3x3 smoothing, and the extra
levels P6 = 3x3/s2 on C5, P7 = 3x3/s2 on relu(P6). All pyramid channels
are 256; the input is padded to a multiple of ``stride`` = 128.
"""

import torch.nn.functional as F
from torch import nn

from .mobilenet import MobileNet
from .registry import register


class FPN(nn.Module):
    stride = 128

    def __init__(self, features):
        super().__init__()
        self.features = features
        c3, c4, c5 = features.feature_channels
        self.lateral3 = nn.Conv2d(c3, 256, 1)
        self.lateral4 = nn.Conv2d(c4, 256, 1)
        self.lateral5 = nn.Conv2d(c5, 256, 1)
        self.pyramid6 = nn.Conv2d(c5, 256, 3, stride=2, padding=1)
        self.pyramid7 = nn.Conv2d(256, 256, 3, stride=2, padding=1)
        self.smooth3 = nn.Conv2d(256, 256, 3, padding=1)
        self.smooth4 = nn.Conv2d(256, 256, 3, padding=1)
        self.smooth5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        c3, c4, c5 = self.features(x)
        p5 = self.lateral5(c5)
        p4 = F.interpolate(p5, scale_factor=2, mode='nearest') \
            + self.lateral4(c4)
        p3 = F.interpolate(p4, scale_factor=2, mode='nearest') \
            + self.lateral3(c3)
        p6 = self.pyramid6(c5)
        p7 = self.pyramid7(F.relu(p6))
        return [self.smooth3(p3), self.smooth4(p4), self.smooth5(p5), p6, p7]


@register
def MobileNetV2FPN():
    return FPN(MobileNet())
