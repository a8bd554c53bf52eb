"""Greedy class-aware NMS over rotated boxes: the CUDA kernel
(csrc/nms_rotated.cu) and its plain PyTorch version.

Replaces the TPU kernel
``odtk_tpu/ops/pallas/nms_rotated_kernel.py:nms_rotated_pallas``. Boxes
are (x1, y1, x2, y2, sin, cos); suppression is by the polygon IoU of
each candidate's quad clipped against the winner's (``ops/iou_rotated.py``
and its device twin ``csrc/quad_iou.cuh``). On the card the rounds are
a scan in score order over a pairwise suppression bitmask: two launches
that rank the live candidates by counting, a mask launch over 64 x 64
tiles of ranks that holds the clips, and a one-warp scan per image that
stops at D kept (see the note in csrc/nms_rotated.cu).
``nms_rotated`` calls the ``odtk::nms_rotated`` operator, whose CPU
implementation is the plain version and whose CUDA one the kernel, so an
exported graph keeps the kernel; there is no fallback between them.
"""

import torch

from ..iou_rotated import _corner_lists, clip_iou, sincos_box_corners
from . import _build

MAX_CANDIDATES = 16384     # the scan's bitset of ranks (nms_rotated.cu)
SKIP_MARGIN = 0.25         # kSkipMargin: the widening of the AABB skip


def nms_rotated_plain(scores, boxes, classes, nms_thresh=0.5,
                      ndetections=100):
    """Plain PyTorch greedy rotated NMS, for CPU tensors and the tests.

    The rounds of ``odtk_tpu/ops/nms.py:_nms_single`` with
    ``_rotated_iou_one_vs_all``, batched: argmax (first index on ties),
    record when the maximum is > 0, then zero the winner and every
    same-class candidate whose IoU against it exceeds nms_thresh.
    scores/classes [B, N], boxes [B, N, 6] -> ([B, D], [B, D, 6], [B, D]).
    """
    s = scores.float().clone()
    boxes = boxes.float()
    classes = classes.float()
    b = s.shape[0]
    out_s = s.new_zeros(b, ndetections)
    out_b = s.new_zeros(b, ndetections, 6)
    out_c = s.new_zeros(b, ndetections)
    if s.shape[1] == 0:
        return out_s, out_b, out_c
    corners = sincos_box_corners(boxes)                    # [B, N, 8]
    rows = torch.arange(b, device=s.device)
    for d in range(ndetections):
        m = s.argmax(dim=1)
        m_val = s[rows, m]
        picked = m_val > 0
        if not bool(picked.any()):
            break                      # every later round records zeros
        mc = classes[rows, m]
        out_s[:, d] = torch.where(picked, m_val, 0.0)
        out_b[:, d] = torch.where(picked[:, None], boxes[rows, m], 0.0)
        out_c[:, d] = torch.where(picked, mc, 0.0)

        cx, cy = _corner_lists(corners[rows, m], 1)        # [B, 1] each
        iou = clip_iou(corners, cx, cy)                    # [B, N]
        suppress = (iou > nms_thresh) & (classes == mc[:, None])
        suppress[rows, m] = True
        s = torch.where(picked[:, None] & suppress, 0.0, s)
    return out_s, out_b, out_c


def nms_rotated(scores, boxes, classes, nms_thresh=0.5, ndetections=100):
    """Batched rotated NMS through the ``odtk::nms_rotated`` operator: the
    plain version on the CPU, the kernel on CUDA. Same contract as
    ``nms_rotated_plain``."""
    if scores.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'nms_rotated: no kernel for device {scores.device}')
    if scores.device.type == 'cuda':
        b, n = scores.shape
        if boxes.shape != (b, n, 6) or classes.shape != (b, n):
            raise ValueError(f'nms_rotated: shapes {tuple(scores.shape)}, '
                             f'{tuple(boxes.shape)}, {tuple(classes.shape)}')
        if n > MAX_CANDIDATES:
            raise ValueError(f'nms_rotated: {n} candidates, the kernel takes '
                             f'at most {MAX_CANDIDATES}')
        if not (boxes.device == classes.device == scores.device):
            raise ValueError('nms_rotated: inputs on different devices')
    return torch.ops.odtk.nms_rotated(scores, boxes, classes,
                                      float(nms_thresh), int(ndetections))


# The operator that an exported graph (``odtk_tpu_torch/export.py``) keeps:
# its CPU implementation is the plain version, its CUDA one the kernel.
@torch.library.custom_op('odtk::nms_rotated', mutates_args=(),
                         device_types='cpu')
def _nms_rotated_op(scores: torch.Tensor, boxes: torch.Tensor,
                    classes: torch.Tensor, nms_thresh: float, ndetections: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return nms_rotated_plain(scores, boxes, classes, nms_thresh, ndetections)


@_nms_rotated_op.register_kernel('cuda')
def _nms_rotated_cuda(scores, boxes, classes, nms_thresh, ndetections):
    b, n = scores.shape
    scores = scores.float().contiguous()
    boxes = boxes.float().contiguous()
    classes = classes.float().contiguous()
    out_s = scores.new_empty(b, ndetections)
    out_b = scores.new_empty(b, ndetections, 6)
    out_c = scores.new_empty(b, ndetections)
    if b == 0 or ndetections == 0:
        return out_s, out_b, out_c
    if n == 0:
        return out_s.zero_(), out_b.zero_(), out_c.zero_()
    words = -(-n // 64)
    # the mask, then int32 ranks, live counts, order and kept ranks
    # (nms_rotated.cu)
    scratch = scores.new_empty(b * (n * words * 2 + 2 * n + 1 + ndetections),
                               dtype=torch.int32)
    with torch.cuda.device(scores.device):
        rc = _build.library().odtk_nms_rotated(
            scores.data_ptr(), boxes.data_ptr(), classes.data_ptr(), b, n,
            ndetections, nms_thresh, scratch.data_ptr(), out_s.data_ptr(),
            out_b.data_ptr(), out_c.data_ptr(),
            _build.stream_handle(scores.device))
    _build.check(rc, 'odtk_nms_rotated')
    nms_rotated.launches += 1
    return out_s, out_b, out_c


@_nms_rotated_op.register_fake
def _nms_rotated_fake(scores, boxes, classes, nms_thresh, ndetections):
    b = scores.shape[0]
    f32 = dict(dtype=torch.float32)
    return (scores.new_empty(b, ndetections, **f32),
            scores.new_empty(b, ndetections, 6, **f32),
            scores.new_empty(b, ndetections, **f32))


nms_rotated.launches = 0
