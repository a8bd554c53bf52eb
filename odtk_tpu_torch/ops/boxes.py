"""Box codecs: (x1, y1, x2, y2) boxes <-> deltas from anchors.

Counterpart of ``odtk_tpu/ops/boxes.py:box2delta`` and ``delta2box``
(axis-aligned). All coordinates use the inclusive-pixel convention,
``w = x2 - x1 + 1``. Tensors only; any leading shape.
"""

import torch


def box2delta(boxes, anchors):
    """Encode boxes as deltas from anchors, [..., 4]:
    (center offset / anchor size, log size ratio)."""
    aw = anchors[..., 2:4] - anchors[..., 0:2] + 1
    actr = anchors[..., 0:2] + 0.5 * aw
    bw = boxes[..., 2:4] - boxes[..., 0:2] + 1
    bctr = boxes[..., 0:2] + 0.5 * bw
    return torch.cat([(bctr - actr) / aw, torch.log(bw / aw)], dim=-1)


def delta2box(deltas, anchors, size, stride):
    """Decode deltas into (x1, y1, x2, y2) boxes clamped to
    ``[0, size * stride - 1]``; ``size`` is (width, height) in cells."""
    aw = anchors[..., 2:4] - anchors[..., 0:2] + 1
    actr = anchors[..., 0:2] + 0.5 * aw
    pred_ctr = deltas[..., 0:2] * aw + actr
    pred_wh = torch.exp(deltas[..., 2:4]) * aw
    lim = torch.tensor([size[0] * stride - 1, size[1] * stride - 1],
                       dtype=deltas.dtype, device=deltas.device)
    lo = torch.minimum(torch.clamp(pred_ctr - 0.5 * pred_wh, min=0), lim)
    hi = torch.minimum(torch.clamp(pred_ctr + 0.5 * pred_wh - 1, min=0), lim)
    return torch.cat([lo, hi], dim=-1)
