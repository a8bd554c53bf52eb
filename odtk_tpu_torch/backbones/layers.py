"""Fixed (buffers-only) batch norm and the int8-weight convolution.

Counterpart of ``odtk_tpu/backbones/layers.py``. ``FixedBatchNorm``'s
four tensors are buffers named as torch's batch norm names them, so
checkpoints load with ``load_state_dict(strict=True)``; it does not
subclass ``nn.BatchNorm2d``, whose ``num_batches_tracked`` buffer the
checkpoints do not carry. The JAX package's ``QuantConv`` is a plain
``nn.Conv2d`` in a checkpoint model; an int8 engine swaps each calibrated
one for a ``QuantConv2d`` (``quantize.build_quant_variables``).
"""

import torch
import torch.nn.functional as F
from torch import nn


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
    """The w8a16 convolution of an int8 engine (``odtk_tpu/backbones/
    layers.py:QuantConv``, ``:307-312``): the weight is stored as an int8
    OIHW buffer with fp32 per-output-channel scales ``w_scale`` [O], and
    dequantized in the forward (int8 -> fp32 * w_scale -> the input's
    dtype) before a plain ``F.conv2d`` in the input's dtype. The bias
    stays fp32 and is cast the same way. Built from an ``nn.Conv2d`` by
    ``from_conv``; it has no gradient."""

    def __init__(self, weight_q, w_scale, bias, stride, padding, dilation,
                 groups):
        super().__init__()
        self.register_buffer('weight', weight_q)
        self.register_buffer('w_scale', w_scale)
        self.register_buffer('bias', bias)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups

    @classmethod
    def from_conv(cls, conv, weight_q, w_scale):
        bias = None if conv.bias is None else conv.bias.detach().float()
        return cls(weight_q, w_scale, bias, conv.stride, conv.padding,
                   conv.dilation, conv.groups)

    def forward(self, x):
        w = (self.weight.float() * self.w_scale[:, None, None, None]
             ).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, bias, self.stride, self.padding, self.dilation,
                        self.groups)
