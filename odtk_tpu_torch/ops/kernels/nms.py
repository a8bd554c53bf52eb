"""Greedy class-aware NMS: the CUDA kernel (csrc/nms.cu) and its plain
PyTorch version.

Replaces the TPU kernel ``odtk_tpu/ops/pallas/nms_kernel.py:nms_pallas``.
On the card the cost is D dependent selection rounds, not bytes; the
kernel takes them out of a block-wide chain: two launches rank the live
candidates by counting, a mask launch over 64 x 64 tiles of ranks sets
the suppression bit of every same-class pair whose IoU exceeds the
threshold, and a one-warp scan per image stops at D kept (see the notes
in csrc/nms.cu and csrc/nms_scan.cuh, shared with the rotated NMS). An
image holding a NaN score records nothing, as the greedy rounds do.
``nms`` calls the ``odtk::nms`` operator, whose CPU implementation is
the plain version and whose CUDA one the kernel, so an exported graph
keeps the kernel; there is no fallback between them.
"""

import torch

from . import _build

MAX_CANDIDATES = 16384     # the scan's bitset of ranks (nms_scan.cuh)


def nms_plain(scores, boxes, classes, nms_thresh=0.5, ndetections=100):
    """Plain PyTorch greedy NMS, for CPU tensors and the tests only.

    The rounds of ``odtk_tpu/ops/nms.py:_nms_single``, batched: argmax
    (first index on ties), record when the maximum is > 0, then zero the
    winner and every same-class candidate with IoU > nms_thresh.
    scores/classes [B, N], boxes [B, N, 4] -> ([B, D], [B, D, 4], [B, D]).
    """
    s = scores.float().clone()
    boxes = boxes.float()
    classes = classes.float()
    b = s.shape[0]
    out_s = s.new_zeros(b, ndetections)
    out_b = s.new_zeros(b, ndetections, 4)
    out_c = s.new_zeros(b, ndetections)
    if s.shape[1] == 0:
        return out_s, out_b, out_c
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    rows = torch.arange(b, device=s.device)
    for d in range(ndetections):
        m = s.argmax(dim=1)
        m_val = s[rows, m]
        picked = m_val > 0
        mb = boxes[rows, m]
        mc = classes[rows, m]
        out_s[:, d] = torch.where(picked, m_val, 0.0)
        out_b[:, d] = torch.where(picked[:, None], mb, 0.0)
        out_c[:, d] = torch.where(picked, mc, 0.0)

        mx1, my1, mx2, my2 = (v[:, None] for v in mb.unbind(-1))
        iw = (torch.minimum(x2, mx2) - torch.maximum(x1, mx1) + 1).clamp(min=0)
        ih = (torch.minimum(y2, my2) - torch.maximum(y1, my1) + 1).clamp(min=0)
        inter = iw * ih
        marea = (mx2 - mx1 + 1) * (my2 - my1 + 1)
        iou = inter / (area + marea - inter)
        suppress = (iou > nms_thresh) & (classes == mc[:, None])
        suppress[rows, m] = True
        s = torch.where(picked[:, None] & suppress, 0.0, s)
    return out_s, out_b, out_c


def nms(scores, boxes, classes, nms_thresh=0.5, ndetections=100):
    """Batched NMS through the ``odtk::nms`` operator: the plain version
    on the CPU, the kernel on CUDA."""
    if scores.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'nms: no kernel for device {scores.device}')
    if scores.device.type == 'cuda':
        b, n = scores.shape
        if boxes.shape != (b, n, 4) or classes.shape != (b, n):
            raise ValueError(f'nms: shapes {tuple(scores.shape)}, '
                             f'{tuple(boxes.shape)}, {tuple(classes.shape)}')
        if n > MAX_CANDIDATES:
            raise ValueError(f'nms: {n} candidates, the kernel takes at most '
                             f'{MAX_CANDIDATES}')
        if not (boxes.device == classes.device == scores.device):
            raise ValueError('nms: inputs on different devices')
    return torch.ops.odtk.nms(scores, boxes, classes, float(nms_thresh),
                              int(ndetections))


# The operator that an exported graph (``odtk_tpu_torch/export.py``) keeps:
# its CPU implementation is the plain version, its CUDA one the kernel.
@torch.library.custom_op('odtk::nms', mutates_args=(), device_types='cpu')
def _nms_op(scores: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
            nms_thresh: float, ndetections: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return nms_plain(scores, boxes, classes, nms_thresh, ndetections)


def scan_scratch(scores, n, ndetections):
    """The one scratch allocation of the bitmask NMS kernels (layout in
    csrc/nms_scan.cuh): per image the [N, ceil(N/64)] 64-bit mask, then
    int32 ranks, live count, NaN flag, order and kept ranks."""
    b = scores.shape[0]
    words = -(-n // 64)
    return scores.new_empty(b * (n * words * 2 + 2 * n + 2 + ndetections),
                            dtype=torch.int32)


@_nms_op.register_kernel('cuda')
def _nms_cuda(scores, boxes, classes, nms_thresh, ndetections):
    b, n = scores.shape
    scores = scores.float().contiguous()
    boxes = boxes.float().contiguous()
    classes = classes.float().contiguous()
    out_s = scores.new_empty(b, ndetections)
    out_b = scores.new_empty(b, ndetections, 4)
    out_c = scores.new_empty(b, ndetections)
    if b == 0 or ndetections == 0:
        return out_s, out_b, out_c
    if n == 0:
        return out_s.zero_(), out_b.zero_(), out_c.zero_()
    scratch = scan_scratch(scores, n, ndetections)
    with torch.cuda.device(scores.device):
        rc = _build.library().odtk_nms(
            scores.data_ptr(), boxes.data_ptr(), classes.data_ptr(), b, n,
            ndetections, nms_thresh, scratch.data_ptr(), out_s.data_ptr(),
            out_b.data_ptr(), out_c.data_ptr(),
            _build.stream_handle(scores.device))
    _build.check(rc, 'odtk_nms')
    nms.launches += 1
    return out_s, out_b, out_c


@_nms_op.register_fake
def _nms_fake(scores, boxes, classes, nms_thresh, ndetections):
    b = scores.shape[0]
    f32 = dict(dtype=torch.float32)
    return (scores.new_empty(b, ndetections, **f32),
            scores.new_empty(b, ndetections, 4, **f32),
            scores.new_empty(b, ndetections, **f32))


nms.launches = 0
