"""Seeded untrained weights, made on the device in a few large calls.

The weights of a fresh RetinaNet as a from-scratch ``train`` draws them:
Kaiming-normal (fan out) backbone convolutions, Xavier-uniform FPN
convolutions, N(0, 0.01) head convolutions, zero biases, the pi = 0.01
prior on the final classification bias, frozen batch norm at the
identity; with one departure: a depthwise convolution is drawn by its
fan in (9), as He's rule keeps a layer's output variance. By fan out
(9 C) its std is sqrt(2 / (9 C)), which shrinks a random MobileNetV2's
activations ~25x a layer until its features and the heads' input are
zero to fp32 (C5 at 5e-9 RMS, every logit the prior's), and the model
then computes nothing that a check could hold. Every normal draw comes
from one ``randn`` call and every uniform draw from one ``rand`` call,
on ``device``, from a generator seeded with ``seed``; the same seed
gives the same weights. The keys are the ``.pth`` names, which the
program and the reference both load.
"""

import math

import torch

from perfbench.reference import retinanet as ref


def _fans(shape):
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


def state_dict(config, seed, device):
    """{key: fp32 tensor on device} for ``config`` (its backbone, classes
    and anchors), drawn from ``seed``."""
    with torch.device('meta'):
        module = ref.RetinaNet(config['backbone'], config['classes'],
                               config['anchors'])
    normal, uniform, out = [], [], {}
    for name, mod in module.named_modules():
        if isinstance(mod, ref.Conv):
            w = mod.weight.shape
            if name.startswith(('cls_head', 'box_head')):
                normal.append((name + '.weight', w, 0.01))
            elif '.features.' in name:
                depthwise = mod.groups == mod.in_channels > 1
                fan = _fans(w)[0 if depthwise else 1]
                normal.append((name + '.weight', w, math.sqrt(2.0 / fan)))
            else:
                fan_in, fan_out = _fans(w)
                uniform.append((name + '.weight', w,
                                math.sqrt(6.0 / (fan_in + fan_out))))
            if mod.bias is not None:
                out[name + '.bias'] = torch.zeros(mod.bias.shape,
                                                  device=device)
        elif isinstance(mod, ref.FrozenBN):
            for key, buf in mod.named_buffers():
                fill = 1.0 if key in ('weight', 'running_var') else 0.0
                out[f'{name}.{key}'] = torch.full(buf.shape, fill,
                                                  device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(sum(math.prod(s) for _, s, _ in normal),
                        generator=g, device=device)
    spread = torch.rand(sum(math.prod(s) for _, s, _ in uniform),
                        generator=g, device=device)
    off = 0
    for key, shape, std in normal:
        n = math.prod(shape)
        out[key] = draws[off:off + n].view(shape) * std
        off += n
    off = 0
    for key, shape, bound in uniform:
        n = math.prod(shape)
        out[key] = (spread[off:off + n].view(shape) * 2 - 1) * bound
        off += n
    out['cls_head.8.bias'].fill_(-math.log((1 - 0.01) / 0.01))
    return {k: out[k] for k in module.state_dict()}
