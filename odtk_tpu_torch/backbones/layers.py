"""Fixed (buffers-only) batch norm and the int8 convolution.

Counterpart of ``odtk_tpu/backbones/layers.py``. ``FixedBatchNorm``'s
four tensors are buffers named as torch's batch norm names them, so
checkpoints load with ``load_state_dict(strict=True)``; it does not
subclass ``nn.BatchNorm2d``, whose ``num_batches_tracked`` buffer the
checkpoints do not carry. The JAX package's ``QuantConv`` is a plain
``nn.Conv2d`` in a checkpoint model; an int8 engine swaps each calibrated
one for a ``QuantConv2d`` (``quantize.build_quant_variables``): w8a16
(int8 weights) or w8a8 (int8 weights and activations).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv_w8a8 import conv_w8a8, pack_weight


class FixedBatchNorm(nn.Module):
    """Inference-only batch norm on NCHW:
    y = (x - mean) / sqrt(var + eps) * weight + bias."""

    eps = 1e-5

    def __init__(self, features):
        super().__init__()
        self.register_buffer('weight', torch.ones(features))
        self.register_buffer('bias', torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))

    def fold(self):
        """The affine as fp32 (scale, shift), each [C]."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale

    def forward(self, x):
        scale, shift = self.fold()
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class QuantConv2d(nn.Module):
    """The convolution of an int8 engine (``odtk_tpu/backbones/layers.py:
    QuantConv``), built from an ``nn.Conv2d`` by ``from_conv``; it has no
    gradient. The bias stays fp32.

    w8a16 (``:307-312``, no ``act_scale``): the weight is stored as an int8
    OIHW buffer with fp32 per-output-channel scales ``w_scale`` [O], and
    dequantized in the forward (int8 -> fp32 * w_scale -> the input's
    dtype) before a plain ``F.conv2d`` in the input's dtype, the bias cast
    the same way.

    w8a8 (``:265-305``, with the calibrated fp32 scalar ``act_scale``): the
    input is quantized to int8 with ``act_scale`` and convolved with the
    int8 weight into int32, rescaled by act_scale * w_scale and biased
    (``ops/kernels/conv_w8a8.py``: the ``odtk::conv_w8a8`` operator, a
    CUDA kernel on the card). The weight is stored in the kernel's layout,
    int8 [O, kh, kw, Cg] with the group's input channels padded to Cg: 4
    for up to 4 (the stem's 3), else a multiple of 16 (``pack_weight``,
    once here). The output is in the
    compute dtype as the JAX ``y.astype(self.dtype)``: autocast's dtype
    where autocast is on (a custom operator is not autocast, so an fp32
    input in a bf16 region still gives bf16), else the input's."""

    def __init__(self, weight_q, w_scale, bias, stride, padding, dilation,
                 groups, act_scale=None):
        super().__init__()
        self.register_buffer('weight', weight_q)
        self.register_buffer('w_scale', w_scale)
        self.register_buffer('bias', bias)
        self.register_buffer('act_scale', act_scale)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups

    @classmethod
    def from_conv(cls, conv, weight_q, w_scale, act_scale=None):
        """w8a16 from the OIHW int8 ``weight_q``, or w8a8 when
        ``act_scale`` (a float32 scalar tensor) is given."""
        bias = None if conv.bias is None else conv.bias.detach().float()
        if act_scale is not None:
            if tuple(conv.dilation) != (1, 1) or isinstance(conv.padding,
                                                            str):
                raise ValueError('w8a8: dilation 1 and integer padding only '
                                 f'(the JAX QuantConv), got dilation '
                                 f'{conv.dilation} padding {conv.padding}')
            weight_q = pack_weight(weight_q)
        return cls(weight_q, w_scale, bias, conv.stride, conv.padding,
                   conv.dilation, conv.groups, act_scale)

    def forward(self, x):
        if self.act_scale is not None:
            kind = x.device.type
            dtype = (torch.get_autocast_dtype(kind)
                     if torch.is_autocast_enabled(kind) else x.dtype)
            return conv_w8a8(x, self.weight, self.w_scale, self.act_scale,
                             self.bias, self.stride, self.padding,
                             self.groups, dtype)
        w = (self.weight.float() * self.w_scale[:, None, None, None]
             ).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, bias, self.stride, self.padding, self.dilation,
                        self.groups)
