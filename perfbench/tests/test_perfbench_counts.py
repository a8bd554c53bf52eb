"""The yardstick's counters against hand counts."""

import math

import torch

from perfbench.lib import counts
from perfbench.reference import retinanet as ref


def test_conv_macs_of_one_conv():
    conv = torch.nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
    # output 64 x 112 x 112, each 3 x 7 x 7 multiply-adds
    assert counts.conv_macs(conv, (3, 224, 224)) == 64 * 112 * 112 * 147


def test_conv_macs_of_a_grouped_conv():
    conv = torch.nn.Conv2d(32, 32, 3, padding=1, groups=32)
    assert counts.conv_macs(conv, (32, 10, 12)) == 32 * 10 * 12 * 9


def test_resnet50_trunk_at_224():
    """The ResNet-50 trunk's published ~4.1 GMAC at 224 x 224 (without
    the classifier) falls out of the reference module tree."""
    with torch.device('meta'):
        net = ref.ResNet50()
    macs = counts.conv_macs(net, (3, 224, 224))
    assert 4.05e9 < macs < 4.15e9


def test_stem_forward_bound_by_hand():
    shape = (8, 64, 448, 576)
    conv = 8 * 64 * 448 * 576
    pooled = 8 * 64 * 224 * 288
    by_bytes = (conv * 2 + pooled * 2) / 3.35e12
    by_ops = 36 * pooled / 67e12
    assert math.isclose(counts.stem_forward_s(shape, 2),
                        max(by_bytes, by_ops))
    assert by_bytes > by_ops


def test_stem_train_bound_by_hand():
    shape = (8, 64, 448, 576)
    conv, pooled = 8 * 64 * 448 * 576, 8 * 64 * 224 * 288
    moved = conv * 2 + pooled * 3
    want = (max(moved / 3.35e12, 36 * pooled / 67e12)
            + max(moved / 3.35e12, 9 * conv / 67e12))
    assert math.isclose(counts.stem_train_s(shape, 2), want)


def test_det_loss_bound_by_hand():
    logits, anchors, fg = 1000 * 80, 1000, 37
    moved = (2 * logits * 2 + anchors * 8 + fg * 4 * 6 + anchors * 4 * 2
             + 8 * 5)
    want = max(moved / 3.35e12, (58 * logits + 16 * fg * 4) / 67e12)
    assert math.isclose(counts.det_loss_s(logits, anchors, fg, 4, 5, 2),
                        want)


def test_nms_bound_by_hand():
    want = max((8 * 2000 * 24 + 8 * 100 * 24) / 3.35e12,
               14 * 8 * 100 * 2000 / 67e12)
    assert math.isclose(counts.nms_s(8, 2000, 100, 100), want)
