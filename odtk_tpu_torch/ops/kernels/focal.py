"""Masked sigmoid-focal sum of one FPN level, with its gradient: the CUDA
kernels (csrc/focal_sum.cu) and their plain PyTorch version.

Replaces ``odtk_tpu/ops/pallas/focal_kernel.py:focal_sum_fused``: its
forward sum (the ``pallas_call`` at ``:123``) and the backward that
recomputes the terms and writes dlogits (``:147``), tied together as the
JAX custom VJP ties them (``:170-182``): the backward saves the inputs,
not unit gradients. Both kernels are bound by memory bandwidth (see the
note in csrc/focal_sum.cu). No path of the JAX package or of the port
calls it: the model's loss is ``loss.detection_loss_sums_levels`` (row
5).
``focal_sum`` takes the plain version for tensors on the CPU and the
kernels for CUDA tensors; there is no fallback between them.
"""

import torch

from ..losses import focal_loss
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256          # kThreads of csrc/focal_sum.cu


def focal_sum_plain(cls_head, cls_idx, depth, classes, alpha=0.25,
                    gamma=2.0):
    """Dense plain version, for CPU tensors and the tests only: the focal
    loss over a one-hot target, summed over valid anchors (depth >= 0),
    fp32, differentiable by autograd. cls_head [B, H, W, A*K] (channel
    a*K + k); cls_idx, depth [B, N] (-1 ignore, 0 background, c+1
    foreground), N = H*W*A anchor-major."""
    b = cls_head.shape[0]
    onehot = ((cls_idx.long()[..., None]
               == torch.arange(classes, device=cls_idx.device))
              & (depth > 0)[..., None])
    logits = cls_head.reshape(b, -1, classes)
    return (focal_loss(logits, onehot, alpha, gamma)
            * (depth >= 0)[..., None]).sum()


def _geometry(x, cls_idx, depth, classes):
    """Shape checks, the targets as fp32 contiguous on x's device, and the
    kernels' (B, A, K, HW, sB, sC, sHW) arguments."""
    if x.device.type != 'cuda' or x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError('focal_sum: the head must be a CUDA fp32/bf16 '
                         f'[B, H, W, A*K] tensor, got {tuple(x.shape)} '
                         f'{x.dtype} {x.device}')
    b, h, w, ck = x.shape
    anchors = ck // classes
    sb, sh, sw, sc = x.stride()
    if anchors * classes != ck or (h > 1 and sh != w * sw):
        raise ValueError(f'focal_sum: head {tuple(x.shape)} with strides '
                         f'{x.stride()} is not [B, H, W, A*{classes}] with '
                         'mergeable H and W')
    cls_idx = cls_idx.to(x.device, torch.float32).contiguous()
    depth = depth.to(x.device, torch.float32).contiguous()
    n = h * w * anchors
    if cls_idx.shape != (b, n) or depth.shape != (b, n):
        raise ValueError(f'focal_sum: cls_idx and depth must be [{b}, {n}]')
    return cls_idx, depth, (b, anchors, classes, h * w, sb, sc, sw)


def focal_sum_kernel(cls_head, cls_idx, depth, classes, alpha=0.25,
                     gamma=2.0):
    """One launch of the forward kernel: the fp32 sum as a [] tensor."""
    cls_idx, depth, geo = _geometry(cls_head, cls_idx, depth, classes)
    b, anchors, _, hw = geo[:4]
    out = torch.empty((), dtype=torch.float32, device=cls_head.device)
    nblocks = -(-hw // _THREADS) * b * anchors
    partials = torch.empty(max(nblocks, 1), dtype=torch.float32,
                           device=cls_head.device)
    if nblocks == 0:
        return out.zero_()
    with torch.cuda.device(cls_head.device):
        rc = _build.library().odtk_focal_sum(
            cls_head.data_ptr(), cls_idx.data_ptr(), depth.data_ptr(),
            partials.data_ptr(), nblocks, out.data_ptr(),
            _DTYPES[cls_head.dtype], *geo, alpha, gamma,
            _build.stream_handle(cls_head.device))
    _build.check(rc, 'odtk_focal_sum')
    focal_sum_kernel.launches += 1
    return out


def focal_sum_dx_kernel(cls_head, cls_idx, depth, g, classes, alpha=0.25,
                        gamma=2.0):
    """One launch of the backward kernel: d(g * sum)/d cls_head, in the
    head's dtype and strides; g is a device scalar (no host sync)."""
    cls_idx, depth, geo = _geometry(cls_head, cls_idx, depth, classes)
    g = g.to(cls_head.device, torch.float32).reshape(1).contiguous()
    dx = torch.empty_like(cls_head)
    if dx.numel() == 0:
        return dx
    if dx.stride() != cls_head.stride():
        raise ValueError(f'focal_sum: head strides {cls_head.stride()} are '
                         'not those of a dense tensor')
    with torch.cuda.device(cls_head.device):
        rc = _build.library().odtk_focal_sum_dx(
            cls_head.data_ptr(), cls_idx.data_ptr(), depth.data_ptr(),
            g.data_ptr(), dx.data_ptr(), _DTYPES[cls_head.dtype], *geo,
            alpha, gamma, _build.stream_handle(cls_head.device))
    _build.check(rc, 'odtk_focal_sum_dx')
    focal_sum_dx_kernel.launches += 1
    return dx


class _FocalSum(torch.autograd.Function):
    """The forward kernel's sum; the backward kernel recomputes the terms
    from the saved inputs. cls_idx and depth get no gradient (zero)."""

    @staticmethod
    def forward(ctx, cls_head, cls_idx, depth, classes, alpha, gamma):
        ctx.save_for_backward(cls_head, cls_idx, depth)
        ctx.args = (classes, alpha, gamma)
        return focal_sum_kernel(cls_head, cls_idx, depth, classes, alpha,
                                gamma)

    @staticmethod
    def backward(ctx, g):
        cls_head, cls_idx, depth = ctx.saved_tensors
        dx = focal_sum_dx_kernel(cls_head, cls_idx, depth, g, *ctx.args)
        return dx, None, None, None, None, None


def focal_sum(cls_head, cls_idx, depth, classes, alpha=0.25, gamma=2.0):
    """Masked focal-loss sum of one level, an fp32 scalar with a gradient
    to cls_head in its dtype (``focal_sum_fused``'s contract). cls_head
    [B, H, W, A*K] (on CUDA: any strides whose H and W merge, such as the
    NHWC view of a contiguous NCHW convolution output); cls_idx [B, N]
    class indices and depth [B, N] (-1 ignore, 0 background, c+1
    foreground), N = H*W*A. The caller normalizes by the foreground
    count."""
    if cls_head.device.type == 'cpu':
        return focal_sum_plain(cls_head, cls_idx, depth, classes, alpha,
                               gamma)
    return _FocalSum.apply(cls_head, cls_idx, depth, classes, float(alpha),
                           float(gamma))


focal_sum_kernel.launches = 0
focal_sum_dx_kernel.launches = 0
