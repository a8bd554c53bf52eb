"""Detection loss, focal + smooth-L1 sums of every FPN level: the CUDA
kernels (csrc/det_loss.cu) and their plain PyTorch version.

Replaces ``odtk_tpu/ops/pallas/focal_kernel.py:detection_loss_sums_fused``.
The forward kernel reads the heads of all levels in the layout the
convolutions leave them in, and index-form targets, in one launch (plus
a fixed-order finish), and writes the per-level sums; the backward
kernel recomputes each element's gradient from the saved heads and
writes ``g * gradient`` once, in one launch. Both are bound by memory
bandwidth (see the note in csrc/det_loss.cu). ``detection_loss_sums_levels``
and ``detection_loss_sums`` (one level) take the plain version for tensors
on the CPU and the kernels for CUDA tensors; there is no fallback between
them.
"""

import ctypes

import torch

from ..losses import focal_loss, smooth_l1_loss
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 128           # kThreads of csrc/det_loss.cu
VECTOR = 8              # kVec: consecutive positions a thread takes
MAX_LEVELS = 8          # kMaxLevels


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


def level_table(hws, batch, anchors, vector_ok):
    """The kernels' split of the levels' work: per level (hw, vec, chunks,
    block0), and the blocks of all levels. A thread takes ``VECTOR``
    consecutive positions of one (image, anchor) row, ``chunks`` of them a
    row; a level's ``batch * anchors * chunks`` threads fill its blocks of
    ``THREADS`` from ``block0``. vec: the level's rows are read and written
    in 16-byte vectors, which needs hw % VECTOR == 0 and aligned tensors
    (``vector_ok``); otherwise the same threads take scalar steps."""
    rows, block0 = [], 0
    for hw, ok in zip(hws, vector_ok):
        chunks = -(-hw // VECTOR)
        rows.append((hw, int(bool(ok) and hw % VECTOR == 0), chunks, block0))
        block0 += -(-batch * anchors * chunks // THREADS)
    return rows, block0


def _nchw(head, name):
    """The NCHW tensor under an NHWC head view, which must be contiguous:
    the kernels read the heads where the convolution left them."""
    x = head.permute(0, 3, 1, 2)
    if not x.is_contiguous():
        raise ValueError(f'detection_loss_sums: {name} must be the NHWC view '
                         'of a contiguous NCHW tensor, got strides '
                         f'{head.stride()}')
    return x


def _as(t, dtype, device):
    """t as a contiguous dtype tensor on device (itself when it is one)."""
    if t.dtype != dtype or t.device != device:
        t = t.to(device, dtype)
    return t if t.is_contiguous() else t.contiguous()


def kernel_operands(cls_heads, box_heads, cls_ts, box_ts, depths, classes):
    """Checked operands of one launch of the kernels (1 to
    ``MAX_LEVELS`` levels), a tuple a level: the NCHW heads, the targets
    as int32 / fp32 contiguous on the heads' device; and (B, A, D)."""
    if not 0 < len(cls_heads) <= MAX_LEVELS:
        raise ValueError(f'detection_loss_sums: {len(cls_heads)} levels, the '
                         f'kernels take 1 to {MAX_LEVELS}')
    levels = []
    geo = None
    for cls_head, box_head, cls_idx, box_t, depth in zip(
            cls_heads, box_heads, cls_ts, box_ts, depths):
        x = _nchw(cls_head, 'cls_head')
        bx = _nchw(box_head, 'box_head')
        b, ck, h, w = x.shape
        anchors = ck // classes
        dim = bx.shape[1] // max(anchors, 1)
        if (x.device.type != 'cuda' or x.dtype not in _DTYPES
                or bx.dtype != x.dtype or bx.device != x.device
                or anchors * classes != ck or anchors * dim != bx.shape[1]
                or bx.shape[0] != b or tuple(bx.shape[2:]) != (h, w)
                or geo not in (None, (b, anchors, dim, x.dtype, x.device))):
            raise ValueError(
                'detection_loss_sums: heads must be CUDA fp32/bf16 tensors '
                'of one dtype, device, batch, anchor count and box width, '
                f'got {tuple(cls_head.shape)} {x.dtype} {x.device} and '
                f'{tuple(box_head.shape)} {bx.dtype}')
        geo = (b, anchors, dim, x.dtype, x.device)
        n = h * w * anchors
        cls_idx = _as(cls_idx, torch.int32, x.device)
        depth = _as(depth, torch.float32, x.device)
        box_t = _as(box_t, torch.float32, x.device)
        if (cls_idx.shape != (b, n) or depth.shape != (b, n)
                or box_t.shape != (b, n, dim)):
            raise ValueError(f'detection_loss_sums: targets must be [{b}, '
                             f'{n}] and [{b}, {n}, {dim}]')
        levels.append((x, bx, cls_idx, depth, box_t))
    return levels, geo[:3]


def _table(levels, geo, grads=None):
    """The host table of csrc/det_loss.cu (11 int64 a level) and the
    blocks it covers; grads: the (dx, dbx) NCHW outputs of the backward."""
    b, anchors, _ = geo
    ptrs = [(x, bx) + (grads[i] if grads else ())
            for i, (x, bx, *_) in enumerate(levels)]
    aligned = [all(t.data_ptr() % 16 == 0 for t in p) for p in ptrs]
    rows, blocks = level_table([x.shape[2] * x.shape[3] for x, *_ in levels],
                               b, anchors, aligned)
    fields = []
    for (x, bx, cls_idx, depth, box_t), row, i in zip(levels, rows,
                                                      range(len(levels))):
        dx, dbx = grads[i] if grads else (None, None)
        fields += [x.data_ptr(), bx.data_ptr(), cls_idx.data_ptr(),
                   depth.data_ptr(), box_t.data_ptr(),
                   dx.data_ptr() if dx is not None else 0,
                   dbx.data_ptr() if dbx is not None else 0, *row]
    return (ctypes.c_longlong * len(fields))(*fields), blocks


def detection_loss_fwd_kernel(levels, geo, classes, alpha=0.25, gamma=2.0,
                              beta=0.11):
    """One forward launch over ``kernel_operands``' levels: fp32 [L, 2], each
    level's (focal sum, smooth-L1 sum)."""
    x = levels[0][0]
    table, blocks = _table(levels, geo)
    sums = torch.empty(len(levels), 2, dtype=torch.float32, device=x.device)
    partials = torch.empty(max(2 * blocks, 2), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().odtk_det_loss_fwd(
            table, len(levels), blocks, partials.data_ptr(), sums.data_ptr(),
            _DTYPES[x.dtype], geo[0], geo[1], classes, geo[2], alpha, gamma,
            beta, _build.stream_handle(x.device))
    _build.check(rc, 'odtk_det_loss_fwd')
    detection_loss_fwd_kernel.launches += 1
    return sums


def detection_loss_bwd_kernel(levels, geo, g, classes, alpha=0.25,
                              gamma=2.0, beta=0.11):
    """One backward launch: the gradients of sum(g * sums) with respect to
    each level's heads, NCHW in the heads' dtype; g fp32 [L, 2] on the
    device (no host sync)."""
    x = levels[0][0]
    g = g.to(x.device, torch.float32).contiguous()
    grads = [(torch.empty_like(lx), torch.empty_like(lbx))
             for lx, lbx, *_ in levels]
    table, blocks = _table(levels, geo, grads)
    with torch.cuda.device(x.device):
        rc = _build.library().odtk_det_loss_bwd(
            table, len(levels), blocks, g.data_ptr(), _DTYPES[x.dtype],
            geo[0], geo[1], classes, geo[2], alpha, gamma, beta,
            _build.stream_handle(x.device))
    _build.check(rc, 'odtk_det_loss_bwd')
    detection_loss_bwd_kernel.launches += 1
    return grads


class _DetectionLossLevels(torch.autograd.Function):
    """The forward kernel's per-level sums; the backward kernel recomputes
    the gradients from the saved heads and targets. The targets get no
    gradient."""

    @staticmethod
    def forward(ctx, classes, alpha, gamma, beta, n, *tensors):
        levels, geo = kernel_operands(
            *(tensors[i * n:(i + 1) * n] for i in range(5)), classes)
        ctx.save_for_backward(*(t for level in levels for t in level))
        ctx.args = (n, geo, classes, alpha, gamma, beta)
        return detection_loss_fwd_kernel(levels, geo, classes, alpha, gamma,
                                         beta)

    @staticmethod
    def backward(ctx, g):
        n, geo, classes, alpha, gamma, beta = ctx.args
        saved = ctx.saved_tensors
        levels = [saved[i * 5:(i + 1) * 5] for i in range(n)]
        grads = detection_loss_bwd_kernel(levels, geo, g, classes, alpha,
                                          gamma, beta)
        dx = [d.permute(0, 2, 3, 1) for d, _ in grads]
        dbx = [d.permute(0, 2, 3, 1) for _, d in grads]
        return (None,) * 5 + tuple(dx) + tuple(dbx) + (None,) * (3 * n)


def detection_loss_sums_levels(cls_heads, box_heads, cls_ts, box_ts, depths,
                               classes, alpha=0.25, gamma=2.0, beta=0.11):
    """(focal sum, smooth-L1 sum) of each level, fp32 [L, 2], with
    gradients to every head. Per level: cls_head [B, H, W, A*K] and
    box_head [B, H, W, A*D] NHWC (on CUDA: NHWC views of contiguous NCHW
    convolution outputs, one dtype for all levels); cls_idx [B, N] class
    indices, depth [B, N] (-1 ignore, 0 background, c+1 foreground),
    box_t [B, N, D] deltas, N = H*W*A anchor-major; any number of levels
    (on CUDA a forward and a backward launch for each group of up to
    ``MAX_LEVELS``). The caller normalizes by the foreground count."""
    n = len(cls_heads)
    if not n or not all(len(t) == n for t in (box_heads, cls_ts, box_ts,
                                              depths)):
        raise ValueError('detection_loss_sums: one head pair and one set of '
                         'targets a level, at least one level')
    device = cls_heads[0].device
    if device.type == 'cpu':
        return torch.stack([torch.stack(detection_loss_sums_plain(
            *level, classes, alpha, gamma, beta)) for level in zip(
                cls_heads, box_heads, cls_ts, box_ts, depths)])
    if device.type != 'cuda':
        raise ValueError(f'detection_loss_sums: no kernel for device {device}')
    sums = [_DetectionLossLevels.apply(
        classes, float(alpha), float(gamma), float(beta),
        len(cls_heads[cut]),
        *(t for part in (cls_heads, box_heads, cls_ts, box_ts, depths)
          for t in part[cut]))
        for cut in _build.level_groups(n, MAX_LEVELS)]
    return sums[0] if len(sums) == 1 else torch.cat(sums)


def detection_loss_sums(cls_head, box_head, cls_idx, box_t, depth, classes,
                        alpha=0.25, gamma=2.0, beta=0.11):
    """(focal sum, smooth-L1 sum) of one level, fp32 scalars, with
    gradients to both heads: ``detection_loss_sums_levels`` of one level
    (the plain version on the CPU)."""
    if cls_head.device.type == 'cpu':
        return detection_loss_sums_plain(cls_head, box_head, cls_idx, box_t,
                                         depth, classes, alpha, gamma, beta)
    sums = detection_loss_sums_levels([cls_head], [box_head], [cls_idx],
                                      [box_t], [depth], classes, alpha,
                                      gamma, beta)
    return sums[0, 0], sums[0, 1]


detection_loss_fwd_kernel.launches = 0
detection_loss_bwd_kernel.launches = 0
