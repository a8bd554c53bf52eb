"""ResNet stem tail, BN + ReLU + 3x3/s2 max pool: the CUDA kernels
(csrc/stem_pool.cu) and their plain PyTorch versions.

Replaces ``odtk_tpu/ops/pallas/stem_kernel.py:fused_bn_relu_pool``: its
primal forward (``bn_relu_pool``, the no-grad path), and under autodiff
its forward that saves the window argmax (``bn_relu_pool_idx``) and its
backward (``bn_relu_pool_bwd``), tied together by ``bn_relu_pool_train``.
All are bound by memory bandwidth (see the note in csrc/stem_pool.cu).
Each wrapper takes the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; there is no fallback between them. The primal
forward goes through the ``odtk::bn_relu_pool`` operator (CPU: plain,
CUDA: kernel), so an exported graph keeps the kernel. The BN
scale and shift are frozen (no gradient), as the JAX package's
``frozen`` collection is.

NaN: a window that holds a NaN post-ReLU value pools to NaN, its code is
``SENTINEL``, and it routes no gradient, in the kernels, in the plain
versions and in the JAX package's ``fused_bn_relu_pool`` alike.
"""

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# max_pool2d's flat index within the window -> the 0..8 candidate code
# (row-major over rows 2p-1..2p+1, cols 2q-1..2q+1); 9 = no gradient
SENTINEL = 9


def _bn_relu(y, scale, shift):
    """relu(y * scale + shift) in fp32, NaN carried. Under autograd a NaN
    element passes no gradient back, as the kernels' and the JAX
    package's routing by the code ``SENTINEL`` do: ReLU's own backward
    would let the cotangent through where its result is NaN."""
    z = torch.relu(y.float() * scale.float()[:, None, None]
                   + shift.float()[:, None, None])
    if z.requires_grad:
        z = torch.where(z.isnan(), z.detach(), z)
    return z


def bn_relu_pool_plain(y, scale, shift):
    """Plain PyTorch version, for CPU tensors and the tests only:
    max_pool2d(relu(y * scale + shift), 3, 2, 1) with the affine in fp32.
    y [B, C, H, W]; scale, shift [C] fp32. Differentiable in y; its
    autograd is the plain version of the backward kernel."""
    return F.max_pool2d(_bn_relu(y, scale, shift), 3, 2, 1).to(y.dtype)


def bn_relu_pool_idx_plain(y, scale, shift):
    """Plain version of the argmax forward: (out, idx int8 codes), from
    max_pool2d's own indices, which keep the window's first maximum; the
    code is ``SENTINEL`` where the max is not > 0 (0 or NaN)."""
    z = _bn_relu(y, scale, shift)
    out, flat = F.max_pool2d(z, 3, 2, 1, return_indices=True)
    hp, wp = out.shape[-2:]
    wc = y.shape[-1]
    p = torch.arange(hp, device=y.device)[:, None]
    q = torch.arange(wp, device=y.device)[None, :]
    dr = flat // wc - 2 * p + 1
    dc = flat % wc - 2 * q + 1
    idx = torch.where(out > 0, 3 * dr + dc, SENTINEL).to(torch.int8)
    return out.to(y.dtype), idx


def _check(name, y, scale, shift):
    if y.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {y.device}')
    if y.dtype not in _DTYPES:
        raise ValueError(f'{name}: dtype {y.dtype} not supported')
    if y.dim() != 4 or not y.is_contiguous():
        raise ValueError(f'{name}: y must be a contiguous NCHW tensor, '
                         f'got shape {tuple(y.shape)} strides {y.stride()}')
    c = y.shape[1]
    scale = scale.to(y.device, torch.float32).contiguous()
    shift = shift.to(y.device, torch.float32).contiguous()
    if scale.shape != (c,) or shift.shape != (c,):
        raise ValueError(f'{name}: scale/shift must be [{c}]')
    return scale, shift


def _pooled(hc, wc):
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def bn_relu_pool(y, scale, shift):
    """Fused stem tail on the NCHW conv1 output y [B, C, Hc, Wc] with the
    folded BN affine scale, shift [C] -> [B, C, Hp, Wp] in y's dtype.
    The primal forward, through the ``odtk::bn_relu_pool`` operator: it
    saves nothing for a backward."""
    if y.device.type != 'cpu':
        scale, shift = _check('bn_relu_pool', y, scale, shift)
    return torch.ops.odtk.bn_relu_pool(y, scale, shift)


# The operator that an exported graph (``odtk_tpu_torch/export.py``) keeps:
# its CPU implementation is the plain version, its CUDA one the kernel.
@torch.library.custom_op('odtk::bn_relu_pool', mutates_args=(),
                         device_types='cpu')
def _bn_relu_pool_op(y: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    return bn_relu_pool_plain(y, scale, shift)


@_bn_relu_pool_op.register_kernel('cuda')
def _bn_relu_pool_cuda(y, scale, shift):
    b, c, hc, wc = y.shape
    out = y.new_empty(b, c, *_pooled(hc, wc))
    if out.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        rc = _build.library().odtk_stem_pool(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            _DTYPES[y.dtype], b, c, hc, wc, *out.shape[2:],
            _build.stream_handle(y.device))
    _build.check(rc, 'odtk_stem_pool')
    bn_relu_pool.launches += 1
    return out


@_bn_relu_pool_op.register_fake
def _bn_relu_pool_fake(y, scale, shift):
    b, c, hc, wc = y.shape
    return y.new_empty(b, c, *_pooled(hc, wc))


def bn_relu_pool_idx(y, scale, shift):
    """The forward of the stem under autodiff: (out, idx), out as
    ``bn_relu_pool`` and idx int8 [B, C, Hp, Wp], each window's first
    maximum as a code 0..8, or 9 where its post-ReLU max is 0 or NaN."""
    if y.device.type == 'cpu':
        return bn_relu_pool_idx_plain(y, scale, shift)
    scale, shift = _check('bn_relu_pool_idx', y, scale, shift)
    b, c, hc, wc = y.shape
    out = y.new_empty(b, c, *_pooled(hc, wc))
    idx = torch.empty(out.shape, dtype=torch.int8, device=y.device)
    if out.numel() == 0:
        return out, idx
    with torch.cuda.device(y.device):
        rc = _build.library().odtk_stem_pool_idx(
            y.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            idx.data_ptr(), _DTYPES[y.dtype], b, c, hc, wc, *out.shape[2:],
            _build.stream_handle(y.device))
    _build.check(rc, 'odtk_stem_pool_idx')
    bn_relu_pool_idx.launches += 1
    return out, idx


def bn_relu_pool_bwd_plain(idx, g, scale, conv_hw):
    """Plain version of the backward, from the saved codes: each pooled
    cotangent goes to its window's argmax, times the BN scale; summed in
    fp32, returned in g's dtype."""
    b, c, hp, wp = g.shape
    hc, wc = conv_hw
    code = idx.long()
    p = torch.arange(hp, device=g.device)[:, None]
    q = torch.arange(wp, device=g.device)[None, :]
    row = 2 * p - 1 + code // 3
    col = 2 * q - 1 + code % 3
    live = code != SENTINEL
    flat = torch.where(live, row * wc + col, 0).reshape(b, c, -1)
    vals = torch.where(live, g.float(), 0.0).reshape(b, c, -1)
    dy = torch.zeros(b, c, hc * wc, dtype=torch.float32, device=g.device)
    dy.scatter_add_(2, flat, vals)
    dy = dy * scale.float().to(g.device)[:, None]
    return dy.reshape(b, c, hc, wc).to(g.dtype)


def bn_relu_pool_bwd(idx, g, scale, conv_hw):
    """The stem's backward: dy [B, C, Hc, Wc] in g's dtype from the saved
    idx codes and the pooled cotangent g [B, C, Hp, Wp]."""
    if g.device.type == 'cpu':
        return bn_relu_pool_bwd_plain(idx, g, scale, conv_hw)
    if g.device.type != 'cuda' or g.dtype not in _DTYPES:
        raise ValueError(f'bn_relu_pool_bwd: no kernel for {g.device} '
                         f'{g.dtype}')
    g = g.contiguous()
    b, c, hp, wp = g.shape
    hc, wc = conv_hw
    if (idx.dtype != torch.int8 or idx.shape != g.shape
            or not idx.is_contiguous() or idx.device != g.device
            or _pooled(hc, wc) != (hp, wp)):
        raise ValueError('bn_relu_pool_bwd: idx must be a contiguous int8 '
                         f'{tuple(g.shape)} tensor on {g.device}, and '
                         f'{conv_hw} must pool to {(hp, wp)}')
    scale = scale.to(g.device, torch.float32).contiguous()
    if scale.shape != (c,):
        raise ValueError(f'bn_relu_pool_bwd: scale must be [{c}]')
    dy = g.new_empty(b, c, hc, wc)
    if dy.numel() == 0:
        return dy
    with torch.cuda.device(g.device):
        rc = _build.library().odtk_stem_pool_bwd(
            idx.data_ptr(), g.data_ptr(), scale.data_ptr(), dy.data_ptr(),
            _DTYPES[g.dtype], b, c, hc, wc, hp, wp,
            _build.stream_handle(g.device))
    _build.check(rc, 'odtk_stem_pool_bwd')
    bn_relu_pool_bwd.launches += 1
    return dy


class _BnReluPool(torch.autograd.Function):
    """Forward with argmax, backward by routing (rows 3 and 4 of the
    kernel table); the frozen scale and shift get no gradient."""

    @staticmethod
    def forward(ctx, y, scale, shift):
        out, idx = bn_relu_pool_idx(y, scale, shift)
        ctx.save_for_backward(idx, scale)
        ctx.conv_hw = tuple(y.shape[2:])
        return out

    @staticmethod
    def backward(ctx, g):
        idx, scale = ctx.saved_tensors
        return bn_relu_pool_bwd(idx, g, scale, ctx.conv_hw), None, None


def bn_relu_pool_train(y, scale, shift):
    """The stem tail where a gradient is wanted: on CUDA the argmax
    forward and routing backward kernels in an autograd Function, on the
    CPU the plain version under autograd."""
    if y.device.type == 'cpu':
        return bn_relu_pool_plain(y, scale, shift)
    return _BnReluPool.apply(y, scale, shift)


bn_relu_pool.launches = 0
bn_relu_pool_idx.launches = 0
bn_relu_pool_bwd.launches = 0
