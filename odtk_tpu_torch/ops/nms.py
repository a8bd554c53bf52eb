"""Batched greedy class-aware NMS, axis-aligned and rotated.

Counterpart of ``odtk_tpu/ops/nms.py:nms`` and ``nms_rotated``:
all_scores [B, N], all_boxes [B, N, 4] (or [B, N, 6] rotated, (x1, y1,
x2, y2, sin, cos)), all_classes [B, N] -> (scores [B, D], boxes [B, D,
4|6], classes [B, D]) in fp32, score-descending and zero-padded. They
are the wrappers of ``ops/kernels/nms.py`` and
``ops/kernels/nms_rotated.py``, which launch the CUDA kernel for a CUDA
tensor and run the plain greedy loop (the rounds of ``_nms_single``)
for a CPU tensor.
"""

from .kernels.nms import nms
from .kernels.nms_rotated import nms_rotated

__all__ = ['nms', 'nms_rotated']
