"""Detection loss of one FPN level, focal + smooth-L1 sums: the CUDA
kernel (csrc/det_loss.cu) and its plain PyTorch version.

Replaces ``odtk_tpu/ops/pallas/focal_kernel.py:detection_loss_sums_fused``.
The kernel reads the heads in the layout the convolutions leave them in
and index-form targets, and writes the two sums and the unit gradients;
it is bound by memory bandwidth (see the note in csrc/det_loss.cu). The
backward is the plain scale ``g * unit gradient``, as the JAX package's
custom VJP is. ``detection_loss_sums`` takes the plain version for
tensors on the CPU and the kernel for CUDA tensors; there is no fallback
between them.
"""

import torch

from ..losses import focal_loss, smooth_l1_loss
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256          # kThreads of csrc/det_loss.cu


def detection_loss_sums_plain(cls_head, box_head, cls_idx, box_t, depth,
                              classes, alpha=0.25, gamma=2.0, beta=0.11):
    """Dense plain version, for CPU tensors and the tests only: the
    masked focal sum over a one-hot target and the masked smooth-L1 sum
    (``odtk_tpu/model.py:348-360``), differentiable by autograd.
    cls_head [B, H, W, A*K], box_head [B, H, W, A*4] (NHWC, channel
    a*K + k); cls_idx, depth [B, N]; box_t [B, N, 4]; N = H*W*A."""
    b = cls_head.shape[0]
    fg = depth > 0
    onehot = ((cls_idx.long()[..., None]
               == torch.arange(classes, device=cls_idx.device))
              & fg[..., None])
    cls_p = cls_head.reshape(b, -1, classes)
    cls_sum = (focal_loss(cls_p, onehot, alpha, gamma)
               * (depth >= 0)[..., None]).sum()
    box_p = box_head.reshape(b, -1, box_t.shape[-1])
    box_sum = (smooth_l1_loss(box_p, box_t, beta) * fg[..., None]).sum()
    return cls_sum, box_sum


def _nchw(head, name):
    """The NCHW tensor under an NHWC head view, which must be contiguous:
    the kernel reads the heads where the convolution left them."""
    x = head.permute(0, 3, 1, 2)
    if not x.is_contiguous():
        raise ValueError(f'detection_loss_sums: {name} must be the NHWC view '
                         'of a contiguous NCHW tensor, got strides '
                         f'{head.stride()}')
    return x


def detection_loss_sums_kernel(cls_head, box_head, cls_idx, box_t, depth,
                               classes, alpha=0.25, gamma=2.0, beta=0.11):
    """One launch of the kernel: (sums fp32 [2], dx, dbx), dx and dbx the
    unit gradients with the heads' shapes, strides and dtype."""
    x = _nchw(cls_head, 'cls_head')
    bx = _nchw(box_head, 'box_head')
    b, ck, h, w = x.shape
    anchors = ck // classes
    dim = bx.shape[1] // anchors
    n = h * w * anchors
    if (x.device.type != 'cuda' or x.dtype not in _DTYPES
            or bx.dtype != x.dtype or bx.device != x.device
            or anchors * classes != ck or anchors * dim != bx.shape[1]
            or bx.shape[0] != b or tuple(bx.shape[2:]) != (h, w)):
        raise ValueError('detection_loss_sums: heads must be CUDA fp32/bf16 '
                         f'tensors of one dtype, got {tuple(cls_head.shape)} '
                         f'{x.dtype} {x.device} and {tuple(box_head.shape)} '
                         f'{bx.dtype}')
    cls_idx = cls_idx.to(x.device, torch.int32).contiguous()
    depth = depth.to(x.device, torch.float32).contiguous()
    box_t = box_t.to(x.device, torch.float32).contiguous()
    if (cls_idx.shape != (b, n) or depth.shape != (b, n)
            or box_t.shape != (b, n, dim)):
        raise ValueError(f'detection_loss_sums: targets must be [{b}, {n}] '
                         f'and [{b}, {n}, {dim}]')
    dx = torch.empty_like(x)
    dbx = torch.empty_like(bx)
    sums = torch.empty(2, dtype=torch.float32, device=x.device)
    nblocks = -(-h * w // _THREADS) * b * anchors
    partials = torch.empty(2 * nblocks, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().odtk_det_loss(
            x.data_ptr(), bx.data_ptr(), cls_idx.data_ptr(),
            depth.data_ptr(), box_t.data_ptr(), dx.data_ptr(),
            dbx.data_ptr(), partials.data_ptr(), nblocks, sums.data_ptr(),
            _DTYPES[x.dtype], b, anchors, classes, dim, h * w, alpha, gamma,
            beta, _build.stream_handle(x.device))
    _build.check(rc, 'odtk_det_loss')
    detection_loss_sums.launches += 1
    return sums, dx.permute(0, 2, 3, 1), dbx.permute(0, 2, 3, 1)


class _DetectionLossSums(torch.autograd.Function):
    """The kernel's sums, with the unit gradients saved for the
    backward, which only scales them by the incoming cotangents."""

    @staticmethod
    def forward(ctx, cls_head, box_head, cls_idx, box_t, depth, classes,
                alpha, gamma, beta):
        sums, dx, dbx = detection_loss_sums_kernel(
            cls_head, box_head, cls_idx, box_t, depth, classes, alpha,
            gamma, beta)
        ctx.save_for_backward(dx, dbx)
        return sums[0], sums[1]

    @staticmethod
    def backward(ctx, g_cls, g_box):
        dx, dbx = ctx.saved_tensors
        # in fp32, rounded once to the heads' dtype, as the plain
        # version's autograd rounds
        dx = (dx.float() * g_cls).to(dx.dtype)
        dbx = (dbx.float() * g_box).to(dbx.dtype)
        return dx, dbx, None, None, None, None, None, None, None


def detection_loss_sums(cls_head, box_head, cls_idx, box_t, depth, classes,
                        alpha=0.25, gamma=2.0, beta=0.11):
    """(focal sum, smooth-L1 sum) of one level, fp32 scalars, with
    gradients to both heads. cls_head [B, H, W, A*K] and box_head
    [B, H, W, A*4] are NHWC (on CUDA: NHWC views of contiguous NCHW
    convolution outputs); cls_idx [B, N] class indices, depth [B, N]
    (-1 ignore, 0 background, c+1 foreground), box_t [B, N, 4] deltas,
    N = H*W*A anchor-major. The caller normalizes by the foreground
    count."""
    if cls_head.device.type == 'cpu':
        return detection_loss_sums_plain(cls_head, box_head, cls_idx, box_t,
                                         depth, classes, alpha, gamma, beta)
    return _DetectionLossSums.apply(cls_head, box_head, cls_idx, box_t,
                                    depth, classes, float(alpha),
                                    float(gamma), float(beta))


detection_loss_sums.launches = 0
