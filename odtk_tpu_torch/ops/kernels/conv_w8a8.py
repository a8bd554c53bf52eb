"""The w8a8 convolution: the CUDA kernels (csrc/conv_w8a8.cu) and their
plain PyTorch version.

The full-int8 branch of ``odtk_tpu/backbones/layers.py:QuantConv``
(``:265-305``), which the JAX package leaves to XLA
(``lax.conv_general_dilated`` on int8 into int32): no Pallas kernel stands
behind it, and PyTorch has no int8 convolution, so the port writes one.

  xq  = clip(round_half_even(x_f32 / act_scale), -127, 127) as int8,
        NaN -> 0, +-inf -> +-127
  acc = int32 sum of xq * wq over (kh, kw, cin / groups), zero padding
  y   = float(acc) * (act_scale * w_scale[o]) + bias[o], cast to out_dtype

The weight is int8 in the kernel's layout, ``[O, kh, kw, Cg]`` with Cg the
input channels of a group rounded up to a multiple of 16 and zeros in the
padding (``pack_weight``); ``QuantConv2d`` stores it so, made once when the
module is built. The wrapper ``conv_w8a8`` goes through the
``odtk::conv_w8a8`` operator: its CPU implementation is the plain version,
its CUDA one the kernels, so an exported engine keeps the kernel; there is
no fallback between them.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_ALIGN = 16      # the kernel's 16-byte words of the contraction


def padded(channels):
    """``channels`` rounded up to a multiple of ``CHANNEL_ALIGN``."""
    return -(-channels // CHANNEL_ALIGN) * CHANNEL_ALIGN


def pack_weight(weight_q):
    """OIHW int8 -> the kernel's [O, kh, kw, padded(I)], zero-padded."""
    o, i, kh, kw = weight_q.shape
    out = weight_q.new_zeros(o, kh, kw, padded(i))
    out[..., :i] = weight_q.permute(0, 2, 3, 1)
    return out


def unpack_weight(weight_q, cin_g):
    """Inverse of ``pack_weight``: OIHW int8 with ``cin_g`` inputs."""
    return weight_q[..., :cin_g].permute(0, 3, 1, 2)


def quantize_activations(x, act_scale):
    """The int8 codes of x: clip(round(x_f32 / act_scale), -127, 127),
    half to even, NaN -> 0. act_scale is a tensor on x's device: PyTorch's
    CUDA division by a CPU scalar multiplies by its reciprocal, which
    rounds otherwise."""
    q = torch.clamp(torch.round(x.float() / act_scale), -127, 127)
    return torch.where(q.isnan(), 0.0, q).to(torch.int8)


def conv_w8a8_plain(x, weight_q, w_scale, act_scale, bias, stride, padding,
                    groups, out_dtype):
    """Plain PyTorch version, for CPU tensors and the tests: the codes,
    then ``F.conv2d`` in float64 on them, exact (every partial sum is an
    integer below 2^53), then the rescale and bias as two fp32 ops. On a
    card the convolution runs without cuDNN, whose float64 algorithms
    need not be exact."""
    xq = quantize_activations(x, act_scale).double()
    w = unpack_weight(weight_q, x.shape[1] // groups).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq, w, None, tuple(stride), tuple(padding), 1, groups)
    y = acc.float() * (act_scale * w_scale)[:, None, None]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(out_dtype)


def out_size(size, kernel, stride, pad):
    return (size + 2 * pad - kernel) // stride + 1


def _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype):
    """Raise on what the kernels do not take: shapes, dtypes and one
    device always, the device type and contiguity for a CUDA tensor."""
    if x.dim() != 4 or weight_q.dim() != 4:
        raise ValueError('conv_w8a8: x must be NCHW and weight_q [O, kh, kw, '
                         f'Cg], got {tuple(x.shape)} and '
                         f'{tuple(weight_q.shape)}')
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f'conv_w8a8: dtypes {x.dtype} -> {out_dtype} not '
                         'supported (float32 or bfloat16)')
    b, c, h, w = x.shape
    o, kh, kw, cg = weight_q.shape
    if (weight_q.dtype != torch.int8 or groups < 1 or c % groups
            or o % groups or cg != padded(c // groups)):
        raise ValueError(f'conv_w8a8: weight_q must be int8 [O, kh, kw, '
                         f'{padded(max(c // max(groups, 1), 1))}] for {c} '
                         f'input channels in {groups} groups, got '
                         f'{weight_q.dtype} {tuple(weight_q.shape)}')
    if (w_scale.shape != (o,) or act_scale.shape != ()
            or (bias is not None and bias.shape != (o,))
            or any(t.dtype != torch.float32 for t in (w_scale, act_scale))
            or (bias is not None and bias.dtype != torch.float32)):
        raise ValueError(f'conv_w8a8: w_scale and bias must be float32 [{o}] '
                         'and act_scale a float32 scalar')
    if len(stride) != 2 or len(padding) != 2 or min(stride) < 1 \
            or min(padding) < 0:
        raise ValueError(f'conv_w8a8: stride {stride} / padding {padding}')
    if min(out_size(h, kh, stride[0], padding[0]),
           out_size(w, kw, stride[1], padding[1])) < 1:
        raise ValueError(f'conv_w8a8: a {kh}x{kw} window does not fit '
                         f'{h}x{w} with padding {padding}')
    tensors = [x, weight_q, w_scale, act_scale] + ([bias] if bias is not None
                                                   else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f'conv_w8a8: every tensor must be on {x.device}')
    if x.device.type == 'cpu':
        return
    if x.device.type != 'cuda':
        raise ValueError(f'conv_w8a8: no kernel for device {x.device}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('conv_w8a8: every tensor must be contiguous')


def conv_w8a8(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
              out_dtype):
    """The w8a8 convolution of x [B, C, H, W] (fp32 or bf16) with the int8
    weight [O, kh, kw, padded(C / groups)], fp32 scales w_scale [O] and
    act_scale [], fp32 bias [O] or None -> [B, O, Ho, Wo] in out_dtype,
    through the ``odtk::conv_w8a8`` operator. Dilation is 1."""
    stride, padding = [int(s) for s in stride], [int(p) for p in padding]
    _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype)
    return torch.ops.odtk.conv_w8a8(x, weight_q, w_scale, act_scale, bias,
                                    stride, padding, groups, out_dtype)


def _out_shape(x, weight_q, stride, padding):
    b, _, h, w = x.shape
    o, kh, kw, _ = weight_q.shape
    return (b, o, out_size(h, kh, stride[0], padding[0]),
            out_size(w, kw, stride[1], padding[1]))


# The operator that an exported graph (``odtk_tpu_torch/export.py``) keeps:
# its CPU implementation is the plain version, its CUDA one the kernels.
@torch.library.custom_op('odtk::conv_w8a8', mutates_args=(),
                         device_types='cpu')
def _conv_w8a8_op(x: torch.Tensor, weight_q: torch.Tensor,
                  w_scale: torch.Tensor, act_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], stride: Sequence[int],
                  padding: Sequence[int], groups: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    return conv_w8a8_plain(x, weight_q, w_scale, act_scale, bias, stride,
                           padding, groups, out_dtype)


@_conv_w8a8_op.register_kernel('cuda')
def _conv_w8a8_cuda(x, weight_q, w_scale, act_scale, bias, stride, padding,
                    groups, out_dtype):
    # an engine's program calls the operator without the wrapper
    _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype)
    if weight_q.data_ptr() % 16:
        raise ValueError('conv_w8a8: weight_q must be 16-byte aligned')
    b, c, h, w = x.shape
    o, kh, kw, _ = weight_q.shape
    out = torch.empty(_out_shape(x, weight_q, stride, padding),
                      dtype=out_dtype, device=x.device)
    xq = torch.empty(b, h, w, padded(c), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().odtk_conv_w8a8(
            x.data_ptr(), _DTYPES[x.dtype], weight_q.data_ptr(),
            w_scale.data_ptr(), act_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), xq.data_ptr(),
            out.data_ptr(), _DTYPES[out_dtype], b, c, h, w, o, kh, kw,
            *stride, *padding, groups, *out.shape[2:],
            _build.stream_handle(x.device))
    _build.check(rc, 'odtk_conv_w8a8')
    conv_w8a8.launches += 1
    return out


@_conv_w8a8_op.register_fake
def _conv_w8a8_fake(x, weight_q, w_scale, act_scale, bias, stride, padding,
                    groups, out_dtype):
    return x.new_empty(_out_shape(x, weight_q, stride, padding),
                       dtype=out_dtype)


conv_w8a8.launches = 0
