"""The yardstick's arithmetic: the card's peaks, the least time each of the
port's kernels could take on its inputs, and the model's operations.

Bytes count each input read once and each output written once, from
the tensors of the call, whatever the implementation reads again; where
the work depends on the data, the count is what these inputs need.
Operations of the port's kernels are fp32 operations; the model's are
2 x the multiply-adds of its convolutions.
"""

import math

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK = {
    'hbm_bytes_per_s': 3.35e12,
    'bf16_flops': 989e12,
    'tf32_flops': 495e12,
    'fp32_flops': 67e12,
    'int8_ops': 1979e12,
}


def bound_s(nbytes, flops, peak='fp32_flops'):
    """The larger of the bytes over the memory rate and the operations
    over the rate the kernel's arithmetic runs at, in seconds."""
    return max(nbytes / PEAK['hbm_bytes_per_s'], flops / PEAK[peak])


def stem_sizes(shape):
    """(conv output elements, pooled elements) of the stem tail on an
    NCHW conv1 output of ``shape`` (3 x 3 / 2 max-pool, padding 1)."""
    b, c, h, w = shape
    return b * c * h * w, b * c * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1)


def stem_forward_s(shape, itemsize):
    """Row 2: the conv output read, the pooled output written; ~36
    operations a pooled element (the affine and ReLU of 9 taps, the max)."""
    conv, pooled = stem_sizes(shape)
    return bound_s(conv * itemsize + pooled * itemsize, 36 * pooled)


def stem_train_s(shape, itemsize):
    """Rows 3 and 4 of one step: the argmax forward (conv read, pooled
    output and its int8 codes written) and the routing backward (the
    pooled cotangent and codes read, the conv-sized gradient written)."""
    conv, pooled = stem_sizes(shape)
    moved = conv * itemsize + pooled * (itemsize + 1)
    return bound_s(moved, 36 * pooled) + bound_s(moved, 9 * conv)


def det_loss_s(logits, anchors, fg_anchors, box_dim, levels, itemsize):
    """Row 5, forward and backward of one step: every logit read and its
    gradient written; each anchor's int32 class and fp32 depth read; the
    box head and fp32 box targets read at foreground anchors only, the
    box gradient written in full; 8 bytes of sums a level. ~58 fp32
    operations a logit and ~16 a foreground box channel."""
    fg_boxes = fg_anchors * box_dim
    moved = (2 * logits * itemsize + anchors * 8 + fg_boxes * (itemsize + 4)
             + anchors * box_dim * itemsize + 8 * levels)
    return bound_s(moved, 58 * logits + 16 * fg_boxes)


def nms_s(batch, candidates, rounds, detections):
    """Row 1 on one batch: scores, boxes and classes of every candidate
    read (24 bytes), the detections written (24 bytes each); each round
    one IoU (~14 operations) of the winner against every candidate."""
    return bound_s(batch * candidates * 24 + batch * detections * 24,
                   14 * batch * rounds * candidates)


def conv_macs(module, image_shape):
    """Multiply-adds of every convolution (and linear layer) of a forward
    of ``module`` on one image of ``image_shape`` (C, H, W), counted from
    the output shapes on the meta device."""
    total = 0

    def hook(mod, args, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            total += out.numel() * (mod.in_channels // mod.groups) * \
                math.prod(mod.kernel_size)
        else:
            total += out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            module(torch.empty(1, *image_shape, device='meta'))
    finally:
        for h in handles:
            h.remove()
    return total
