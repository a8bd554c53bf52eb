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
input channels of a group packed by ``padded`` (4 for up to 4, else a
multiple of 16) and zeros in the padding (``pack_weight``);
``QuantConv2d`` stores it so, made once when the module is built. The
wrapper ``conv_w8a8`` goes through the ``odtk::conv_w8a8`` operator: its
CPU implementation is the plain version, its CUDA one the kernels, so an
exported engine keeps the kernel; there is no fallback between them.

On the card an ungrouped call runs as a tiled implicit GEMM whose launch
plan (``plan``: the N tile, the split of K, the route of A) comes from the
call's shapes alone, cached by shape, so that it is tested on the CPU.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {'gather': 0, 'dense': 1, 'packed': 2}   # csrc's Route
CHANNEL_ALIGN = 16      # the kernel's 16-byte words of the contraction
SMALL_CHANNELS = 4      # up to 4 input channels: one 4-byte word a tap
SMS = 132               # the H100's streaming multiprocessors
TILE_M = 128            # output pixels a tile (two consumer warpgroups)
TILE_K = 128            # contraction bytes a K tile (a stage of the ring)
TILE_N = (256, 128, 64)  # the kernel's N tiles, widest first
# The plan's cost model, in us of an SM's time, fitted to the kernels'
# device times at ResNet50FPN's shapes on an H100 80GB HBM3 at 700 W: a
# work unit's fixed cost (ring fill, epilogue) and a K tile's, by N tile;
# the split-K finish pass's fixed cost and its bytes' rate.
UNIT_US = {64: 1.2, 128: 2.2, 256: 4.6}
K_TILE_US = {64: 0.62, 128: 0.80, 256: 1.03}
FINISH_US = 1.0
FINISH_BYTES_PER_US = 1.5e6


def padded(channels):
    """``channels`` as the kernels pack them a pixel: ``SMALL_CHANNELS``
    for up to that many (the stem's 3: K = kh kw 4, not kh kw 16), else
    rounded up to a multiple of ``CHANNEL_ALIGN``."""
    if channels <= SMALL_CHANNELS:
        return SMALL_CHANNELS
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


class Plan(NamedTuple):
    """How the kernels run one call. ``route``: 'direct' (groups > 1, one
    thread an output), 'dense' (a 1 x 1 stride-1 call: A is the NHWC
    copy itself, loaded by TMA), 'packed' (up to 4 input channels: A's
    taps and the weight's rows by 4-byte cp.async) or 'gather' (A's window
    rows gathered by 16-byte cp.async). The GEMM's work units are 128 x
    ``bn`` output tiles, each summing one of ``splits`` slices of
    ``k_per`` K tiles (the last slice takes the rest) into an int32
    workspace of ``ws_elems`` when ``splits`` > 1; a persistent grid of
    min(units, SMs) blocks walks them."""
    route: str
    bn: int
    splits: int
    k_per: int
    k_tiles: int
    m_tiles: int
    n_tiles: int
    m: int
    ho: int
    wo: int
    ws_elems: int

    @property
    def units(self):
        """(tile, K slice) work units of the GEMM."""
        return self.m_tiles * self.n_tiles * self.splits


def plan_cost(m, n, k_tiles, bn, k_per):
    """Modelled device us of the GEMM (and finish pass) of an M x N call
    of ``k_tiles`` K tiles cut into slices of ``k_per``: rounds of SMS
    units, each a unit's fixed cost and its K tiles', plus the finish
    pass's reads of the slices and write of a bf16 output."""
    splits = -(-k_tiles // k_per)
    units = -(-m // TILE_M) * -(-n // bn) * splits
    cost = -(-units // SMS) * (UNIT_US[bn] + k_per * K_TILE_US[bn])
    if splits > 1:
        cost += FINISH_US + (4 * splits + 2) * m * n / FINISH_BYTES_PER_US
    return cost


@functools.lru_cache(maxsize=4096)
def plan(b, c, h, w, n, kh, kw, sh, sw, ph, pw, groups):
    """The launch plan of a call from its shapes (``Plan``): the N tile
    of ``TILE_N`` no wider than N's own and the split of K that
    ``plan_cost`` rates cheapest (ties: the wider tile, fewer slices).
    A split puts idle SMs to work where the tiles are fewer than SMs, at
    the price of the finish pass."""
    ho, wo = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    m = b * ho * wo
    m_tiles = -(-m // TILE_M)
    k_tiles = -(-kh * kw * padded(c // groups) // TILE_K)
    if groups > 1:
        return Plan('direct', 0, 1, k_tiles, k_tiles, m_tiles, 0, m, ho, wo,
                    0)
    if padded(c) == SMALL_CHANNELS:
        route = 'packed'
    elif (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        route = 'dense'
    else:
        route = 'gather'
    widest = (TILE_N[-1] if route == 'packed' else
              next(t for t in reversed(TILE_N) if t >= min(n, TILE_N[0])))
    _, bn, k_per = min(
        (plan_cost(m, n, k_tiles, t, k_per), -t, k_per)
        for t in TILE_N if t <= widest
        for k_per in {-(-k_tiles // s) for s in range(1, k_tiles + 1)})
    bn = -bn
    n_tiles, splits = -(-n // bn), -(-k_tiles // k_per)
    return Plan(route, bn, splits, k_per, k_tiles, m_tiles, n_tiles, m, ho,
                wo, splits * n * m if splits > 1 else 0)


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
    through the ``odtk::conv_w8a8`` operator, whose implementations (the
    plain one, the kernels', the fake one) each check the arguments once.
    An eager call on the card (a plain CUDA tensor, nothing tracing) goes
    to the kernels' implementation directly: the operator's dispatch costs
    the host more than the call's launches. Dilation is 1."""
    stride, padding = [int(s) for s in stride], [int(p) for p in padding]
    if (type(x) is torch.Tensor and x.is_cuda
            and not torch.compiler.is_compiling()):
        return _conv_w8a8_cuda(x, weight_q, w_scale, act_scale, bias, stride,
                               padding, groups, out_dtype)
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
    _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype)
    return conv_w8a8_plain(x, weight_q, w_scale, act_scale, bias, stride,
                           padding, groups, out_dtype)


@functools.lru_cache(maxsize=4096)
def _weight_map(ptr, n, k, bn):
    """The TMA descriptor (128 bytes of host memory) of the packed weight
    at ``ptr``, [n, k] int8, for N tiles of ``bn`` rows: encoded once for
    each weight buffer, since it holds only the address and the shape."""
    buf = ctypes.create_string_buffer(128)
    _build.check(_build.library().odtk_conv_w8a8_weight_map(ptr, n, k, bn,
                                                           buf),
                 'odtk_conv_w8a8_weight_map')
    return buf


@_conv_w8a8_op.register_kernel('cuda')
def _conv_w8a8_cuda(x, weight_q, w_scale, act_scale, bias, stride, padding,
                    groups, out_dtype):
    # an engine's program calls the operator without the wrapper
    _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype)
    if weight_q.data_ptr() % 16:
        raise ValueError('conv_w8a8: weight_q must be 16-byte aligned')
    b, c, h, w = x.shape
    o, kh, kw, cg = weight_q.shape
    p = plan(b, c, h, w, o, kh, kw, *stride, *padding, groups)
    out = torch.empty((b, o, p.ho, p.wo), dtype=out_dtype, device=x.device)
    xq = torch.empty(b, h, w, padded(c), dtype=torch.int8, device=x.device)
    ws = (torch.empty(p.ws_elems, dtype=torch.int32, device=x.device)
          if p.ws_elems else None)
    lib = _build.library()
    w_map = (None if p.route in ('direct', 'packed') else
             _weight_map(weight_q.data_ptr(), o, kh * kw * cg, p.bn))
    with torch.cuda.device(x.device):
        rc = lib.odtk_conv_w8a8(
            x.data_ptr(), _DTYPES[x.dtype], weight_q.data_ptr(), w_map,
            w_scale.data_ptr(), act_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), xq.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(),
            _DTYPES[out_dtype], b, c, h, w, o, kh, kw, *stride, *padding,
            groups, p.ho, p.wo, p.bn, p.splits, p.k_per,
            _ROUTES.get(p.route, 0), _build.stream_handle(x.device))
    _build.check(rc, 'odtk_conv_w8a8')
    conv_w8a8.launches += 1
    return out


@_conv_w8a8_op.register_fake
def _conv_w8a8_fake(x, weight_q, w_scale, act_scale, bias, stride, padding,
                    groups, out_dtype):
    _check(x, weight_q, w_scale, act_scale, bias, stride, padding, groups,
           out_dtype)
    return x.new_empty(_out_shape(x, weight_q, stride, padding),
                       dtype=out_dtype)


conv_w8a8.launches = 0
