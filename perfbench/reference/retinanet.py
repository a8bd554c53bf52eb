"""Plain PyTorch RetinaNet: the yardstick that decides ``correct``.

Written from the published description (Lin et al., "Focal Loss for
Dense Object Detection", and NVIDIA's retinanet-examples): backbones
(ResNet50 and MobileNetV2 feature extractors with frozen batch norm),
FPN (P3-P7, 256 channels), the shared 4 x conv heads, anchors, the box
codec, the IoU assignment, focal plus smooth-L1 loss normalized by the
foreground count, SGD with momentum and L2 weight decay in the gradient,
and the post-processing: sigmoid, one top-k over all levels, greedy
class-aware NMS. Everything runs in float32 with TF32 off (the caller
sets that), with no fused kernel, cache or batching trick.

Module names follow the ``.pth`` checkpoint keys
(``backbones.ResNet50FPN.features.layer1.0.conv1.weight``,
``cls_head.8.bias``), so one state_dict loads here and in the program.

The control of the comparison is this module computed one precision
below the program's bf16: ``set_fp8(module, True)`` rounds every
convolution's input, weight and output to float8 e4m3 (a per-tensor
scale, as FP8 training scales) and the gradient arriving at its output to
float8 e5m2, where the program keeps each of these in bf16; the
arithmetic in between stays float32.

This file imports nothing of the program under test.
"""

import importlib.util
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# --------------------------------------------------------------- fp8 control

def fake_quant(t, dtype):
    """t rounded to ``dtype`` (a float8 type) under a per-tensor scale that
    maps its largest magnitude to the type's largest finite value."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (t.float() * scale).to(dtype).float().div(scale).to(t.dtype)


class _QuantOperand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _QuantOutput(torch.autograd.Function):
    """Forward: the output in e4m3. Backward: the incoming gradient in
    e5m2."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, torch.float8_e5m2)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in fp8 when ``fp8`` is set."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        y = F.conv2d(_QuantOperand.apply(x), _QuantOperand.apply(self.weight),
                     self.bias, self.stride, self.padding, self.dilation,
                     self.groups)
        return _QuantOutput.apply(y)


def set_fp8(module, on):
    for m in module.modules():
        if isinstance(m, Conv):
            m.fp8 = bool(on)
    return module


# ----------------------------------------------------------------- backbones

class FrozenBN(nn.Module):
    """y = (x - mean) / sqrt(var + 1e-5) * weight + bias, all buffers."""

    def __init__(self, n):
        super().__init__()
        for name, value in (('weight', 1.0), ('bias', 0.0),
                            ('running_mean', 0.0), ('running_var', 1.0)):
            self.register_buffer(name, torch.full((n,), value))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    return Conv(cin, cout, k, stride, k // 2, groups=groups, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = _conv(cin, planes, 1), FrozenBN(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBN(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), FrozenBN(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride),
                                         FrozenBN(out))
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None
                           else self.downsample(x)))


class ResNet50(nn.Module):
    """ResNet-50 to C5; returns C3, C4, C5 (strides 8, 16, 32)."""

    channels = (512, 1024, 2048)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for i, blocks in enumerate((3, 4, 6, 3)):
            planes = 64 * 2 ** i
            layer = []
            for j in range(blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                layer.append(Bottleneck(cin, planes, stride, j == 0))
                cin = planes * 4
            self.add_module(f'layer{i + 1}', nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def _conv_bn_relu6(cin, cout, k, stride=1, groups=1):
    return nn.Sequential(_conv(cin, cout, k, stride, groups), FrozenBN(cout),
                         nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        layers = [_conv_bn_relu6(cin, hidden, 1)] if expand != 1 else []
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, hidden),
                   _conv(hidden, cout, 1), FrozenBN(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        return x + self.conv(x) if self.residual else self.conv(x)


class MobileNetV2(nn.Module):
    """MobileNetV2 (Sandler et al.), width 1.0; returns the outputs of
    blocks 6, 13 and 17 (strides 8, 16, 32)."""

    channels = (32, 96, 320)
    # (expansion, output channels, repeats, first stride)
    settings = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    taps = (6, 13, 17)

    def __init__(self):
        super().__init__()
        blocks, cin = [_conv_bn_relu6(3, 32, 3, 2)], 32
        for t, c, n, s in self.settings:
            for i in range(n):
                blocks.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
        self.features = nn.Sequential(*blocks)

    def forward(self, x):
        outs = []
        for i, block in enumerate(self.features):
            x = block(x)
            if i in self.taps:
                outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.features = features
        c3, c4, c5 = features.channels
        self.lateral3 = _conv(c3, 256, 1, bias=True)
        self.lateral4 = _conv(c4, 256, 1, bias=True)
        self.lateral5 = _conv(c5, 256, 1, bias=True)
        self.pyramid6 = _conv(c5, 256, 3, 2, bias=True)
        self.pyramid7 = _conv(256, 256, 3, 2, bias=True)
        self.smooth3 = _conv(256, 256, 3, bias=True)
        self.smooth4 = _conv(256, 256, 3, bias=True)
        self.smooth5 = _conv(256, 256, 3, bias=True)

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


HERE = os.path.dirname(os.path.abspath(__file__))
BACKBONES = {'ResNet50FPN': lambda: FPN(ResNet50()),
             'MobileNetV2FPN': lambda: FPN(MobileNetV2())}


def make_backbone(name):
    """The plain backbone ``name``: one of ``BACKBONES``, or what
    ``build()`` of ``reference/<name>.py`` returns, the file a further
    configuration brings beside its own."""
    if name in BACKBONES:
        return BACKBONES[name]()
    path = os.path.join(HERE, name + '.py')
    if not os.path.isfile(path):
        raise KeyError(f'no plain backbone {name!r}: not in BACKBONES and '
                       f'no {path}')
    spec = importlib.util.spec_from_file_location(
        'perfbench_reference_' + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build()


def _head(out):
    layers = []
    for _ in range(4):
        layers += [_conv(256, 256, 3, bias=True), nn.ReLU()]
    layers.append(_conv(256, out, 3, bias=True))
    return nn.Sequential(*layers)


class RetinaNet(nn.Module):
    def __init__(self, backbone, classes, anchors):
        super().__init__()
        self.backbones = nn.ModuleDict({backbone: make_backbone(backbone)})
        self.cls_head = _head(classes * anchors)
        self.box_head = _head(4 * anchors)
        self.classes, self.anchors = classes, anchors

    def forward(self, x):
        """x [B, 3, H, W] -> per level (logits [B, H*W*A, K],
        deltas [B, H*W*A, 4]), anchor n = (h * W + w) * A + a."""
        out = []
        for f in next(iter(self.backbones.values()))(x):
            c, b = self.cls_head(f), self.box_head(f)
            n = c.shape[0]
            out.append((c.permute(0, 2, 3, 1).reshape(n, -1, self.classes),
                        b.permute(0, 2, 3, 1).reshape(n, -1, 4)))
        return out


def trainable(module):
    """(name, parameter) of every parameter, in state_dict order."""
    return list(module.named_parameters())


# ------------------------------------------------------------------- images

def normalize_train(images_u8, colors, sizes):
    """u8 NHWC -> normalized NCHW fp32: the per-image colour affine
    (colors [B, 3, 4]: x @ t + off), the clip to the normalized [0, 1]
    range, the canvas outside each valid (h, w) zeroed."""
    x = images_u8.float()
    t, off = colors[:, :, :3].float(), colors[:, :, 3].float()
    y = torch.einsum('bhwc,bcd->bhwd', x, t) + off[:, None, None, :]
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    lo, hi = ((0 - mean) / std).to(y), ((1 - mean) / std).to(y)
    y = torch.maximum(torch.minimum(y, hi), lo)
    return _mask(y, sizes).permute(0, 3, 1, 2).contiguous()


def normalize_eval(images_u8, sizes):
    x = images_u8.float()
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    y = (x / 255.0 - mean) / std
    return _mask(y, sizes).permute(0, 3, 1, 2).contiguous()


def _mask(y, sizes):
    h, w = y.shape[1:3]
    rows = torch.arange(h, device=y.device)[None, :, None]
    cols = torch.arange(w, device=y.device)[None, None, :]
    sizes = sizes.to(y.device)
    valid = (rows < sizes[:, 0, None, None]) & (cols < sizes[:, 1, None, None])
    return y * valid[..., None]


# ------------------------------------------------------------------ anchors

def anchor_table(stride, ratios, scales):
    """[A, 4] anchor offsets (x1, y1, x2, y2) in a stride x stride cell,
    scale-major, ratio-minor: the base box of area stride^2 reshaped to
    each ratio (h / w) and scaled, centred on the cell."""
    rows = []
    for s in scales:
        for r in ratios:
            w = math.sqrt(stride * stride / r)
            dw, dh = w * s, w * r * s
            rows.append([0.5 * (stride - dw), 0.5 * (stride - dh),
                         0.5 * (stride + dw), 0.5 * (stride + dh)])
    return torch.tensor(rows, dtype=torch.float32)


def level_anchors(w, h, stride, table):
    """[h * w * A, 4] anchors of a level, anchor-major."""
    table = table.to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=table.device) * stride
    ys = torch.arange(h, dtype=torch.float32, device=table.device) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    cell = torch.stack([gx, gy, gx, gy], -1)
    return (cell[:, :, None, :] + table).reshape(-1, 4)


def encode(boxes, anchors):
    """Boxes -> deltas (inclusive-pixel sizes: w = x2 - x1 + 1)."""
    aw = anchors[..., 2:] - anchors[..., :2] + 1
    ac = anchors[..., :2] + 0.5 * aw
    bw = boxes[..., 2:] - boxes[..., :2] + 1
    bc = boxes[..., :2] + 0.5 * bw
    return torch.cat([(bc - ac) / aw, torch.log(bw / aw)], -1)


def decode_boxes(deltas, anchors, width, height):
    """Deltas -> (x1, y1, x2, y2): x1, y1 clamped below at 0, x2, y2 above
    at the canvas's last pixel."""
    aw = anchors[..., 2:] - anchors[..., :2] + 1
    ac = anchors[..., :2] + 0.5 * aw
    ctr = deltas[..., :2] * aw + ac
    wh = torch.exp(deltas[..., 2:]) * aw
    lim = torch.tensor([width - 1.0, height - 1.0], device=deltas.device)
    return torch.cat([torch.clamp(ctr - 0.5 * wh, min=0.0),
                      torch.minimum(ctr + 0.5 * wh - 1.0, lim)], -1)


def iou(a, b):
    """Pairwise IoU of [..., N, 4] and [..., M, 4], inclusive pixels."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + 1).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / (area_a + area_b - inter)


# ------------------------------------------------------------- the training

def assign(targets, anchors, ious=(0.4, 0.5)):
    """targets [B, M, 5] (x, y, w, h, class; class -1 pads) against
    anchors [N, 4] -> (cls [B, N] long, deltas [B, N, 4], depth [B, N]):
    depth -1 ignore, 0 background, c + 1 foreground of class c; each
    anchor takes its highest-IoU box, the first on a tie."""
    cls = targets[..., 4]
    wh = targets[..., 2:4].clamp(min=1e-4)
    boxes = torch.cat([targets[..., :2], targets[..., :2] + wh - 1], -1)
    overlap = iou(anchors.expand(targets.shape[0], -1, -1), boxes)
    overlap = torch.where((cls > -1)[:, None, :], overlap, -1.0)
    best, first = overlap.max(dim=2)
    best_cls = torch.gather(cls, 1, first)
    best_box = torch.gather(boxes, 1, first[..., None].expand(-1, -1, 4))
    depth = torch.where(best < ious[0], 0.0,
                        torch.where(best >= ious[1], best_cls + 1.0, -1.0))
    return best_cls.clamp(min=0).long(), encode(best_box, anchors), depth


def focal_loss(logits, onehot, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, onehot, reduction='none')
    p_t = torch.where(onehot == 1, p, 1 - p)
    alpha_t = torch.where(onehot == 1, alpha, 1 - alpha)
    return alpha_t * (1 - p_t) ** gamma * ce


def smooth_l1(pred, target, beta=0.11):
    x = (pred - target).abs()
    return torch.where(x >= beta, x - 0.5 * beta, 0.5 * x * x / beta)


class Levels:
    """The anchors of each FPN level of an H x W canvas."""

    def __init__(self, height, width, ratios, scales, device,
                 strides=(8, 16, 32, 64, 128)):
        self.height, self.width = height, width
        self.strides = strides
        self.anchors = [level_anchors(width // s, height // s, s,
                                      anchor_table(s, ratios, scales)
                                      .to(device)) for s in strides]


def targets_of(levels, targets, ious):
    """Per level (cls, deltas, depth) of padded targets."""
    return [assign(targets.float(), a, ious) for a in levels.anchors]


def fg_total(assigned):
    """sum over levels of max(foreground anchors of the batch, 1)."""
    return sum(torch.clamp((d > 0).sum(), min=1) for _, _, d in assigned
               ).float()


def loss_sums(outputs, assigned, classes):
    """(focal sum, smooth-L1 sum) over all levels: focal over anchors with
    depth >= 0 against the one-hot class of foreground anchors, smooth-L1
    over foreground anchors."""
    cls_sum = box_sum = 0.0
    for (logits, deltas), (cls, box_t, depth) in zip(outputs, assigned):
        fg = depth > 0
        onehot = (F.one_hot(cls, classes).float() * fg[..., None])
        cls_sum = cls_sum + (focal_loss(logits.float(), onehot)
                             * (depth >= 0)[..., None]).sum()
        box_sum = box_sum + (smooth_l1(deltas.float(), box_t)
                             * fg[..., None]).sum()
    return cls_sum, box_sum


def loss_and_grads(model, images, targets, levels, ious, block):
    """(cls_loss, box_loss, grads) of one batch: the sums over the batch
    divided by the batch's foreground count, the gradients accumulated over
    blocks of ``block`` images so that fp32 activations fit. ``images``
    is a callable i, j -> the normalized NCHW images i:j."""
    assigned = targets_of(levels, targets, ious)
    total = fg_total(assigned)
    params = [p for _, p in trainable(model)]
    grads = [torch.zeros_like(p) for p in params]
    n = targets.shape[0]
    cls_l = box_l = 0.0
    for i in range(0, n, block):
        j = min(i + block, n)
        part = [(c[i:j], b[i:j], d[i:j]) for c, b, d in assigned]
        cs, bs = loss_sums(model(images(i, j)), part, model.classes)
        g = torch.autograd.grad((cs + bs) / total, params, allow_unused=True)
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi
        cls_l, box_l = cls_l + cs.detach() / total, box_l + bs.detach() / total
    return cls_l, box_l, grads


def sgd(params, grads, bufs, lr, weight_decay, momentum):
    """One SGD step, momentum with dampening 0, L2 decay into the
    gradient: buf = momentum * buf + (g + wd * p); p -= lr * buf."""
    with torch.no_grad():
        for p, g, buf in zip(params, grads, bufs):
            buf.mul_(momentum).add_(g + weight_decay * p)
            p.sub_(lr * buf)


# --------------------------------------------------------------- inference

def candidates(outputs, levels):
    """All candidates of a forward: logits [B, N, K] and decoded boxes
    [B, N, 4] over every level's anchors, level-major."""
    logits = torch.cat([o[0] for o in outputs], 1).float()
    boxes = torch.cat([decode_boxes(o[1].float(), a, levels.width,
                                    levels.height)
                       for o, a in zip(outputs, levels.anchors)], 1)
    return logits, boxes


def anchor_sides(levels):
    """[N] the longer side of each anchor, level-major: the scale at which
    a box is decoded from its deltas."""
    a = torch.cat(levels.anchors)
    return torch.maximum(a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]) + 1


def detect(logits, boxes, total, threshold, nms_iou, detections):
    """The post-processing: the ``total`` largest logits over all anchors
    and classes, their scores zeroed under ``threshold``, then greedy
    class-aware NMS: (scores [B, D], boxes [B, D, 4], classes [B, D]),
    score-descending, zero-padded."""
    k = logits.shape[-1]
    z, idx = torch.topk(logits.reshape(logits.shape[0], -1), total, dim=1)
    s = torch.where(torch.sigmoid(z) > threshold, torch.sigmoid(z), 0.0)
    b = torch.gather(boxes, 1, (idx // k)[..., None].expand(-1, -1, 4))
    c = (idx % k).float()
    out_s = s.new_zeros(s.shape[0], detections)
    out_b = s.new_zeros(s.shape[0], detections, 4)
    out_c = s.new_zeros(s.shape[0], detections)
    rows = torch.arange(s.shape[0], device=s.device)
    for d in range(detections):
        m = s.argmax(dim=1)
        top = s[rows, m]
        picked = top > 0
        out_s[:, d] = torch.where(picked, top, 0.0)
        out_b[:, d] = torch.where(picked[:, None], b[rows, m], 0.0)
        out_c[:, d] = torch.where(picked, c[rows, m], 0.0)
        over = iou(b[rows, m][:, None], b)[:, 0] > nms_iou
        gone = (over & (c == c[rows, m][:, None])) | (
            torch.arange(s.shape[1], device=s.device)[None] == m[:, None])
        s = torch.where(picked[:, None] & gone, 0.0, s)
    return out_s, out_b, out_c
