"""Box codecs (boxes <-> deltas from anchors) and rotated-box geometry.

Counterpart of ``odtk_tpu/ops/boxes.py``: ``box2delta``/``delta2box``,
their 6-channel rotated forms, ``order_points`` and ``rotate_boxes``.
All coordinates use the inclusive-pixel convention, ``w = x2 - x1 + 1``.
Tensors only; any leading shape.
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


def box2delta_rotated(boxes, anchors):
    """Encode rotated boxes (x1, y1, x2, y2, sin, cos) against axis-aligned
    anchors, [..., 6]: the four ``box2delta`` channels, then sin and cos
    passed through."""
    return torch.cat([box2delta(boxes[..., :4], anchors), boxes[..., 4:6]],
                     dim=-1)


def delta2box_rotated(deltas, anchors, size, stride):
    """Decode 6-channel rotated deltas into (x1, y1, x2, y2, sin, cos):
    ``delta2box`` of the first four, the raw (sin, cos) carried through."""
    return torch.cat([delta2box(deltas[..., :4], anchors, size, stride),
                      deltas[..., 4:6]], dim=-1)


def order_points(pts):
    """Canonicalize 4-corner polygons [..., 4, 2] to (tl, tr, br, bl):
    sort by x; the two left-most sorted by y give (tl, bl); of the two
    right-most, the farther from tl is br. The sorts are stable, as
    JAX's are, so a tie of x keeps the input order."""
    idx = torch.argsort(pts[..., 0], dim=-1, stable=True)
    xs = torch.gather(pts, -2, idx[..., None].expand(*idx.shape, 2))
    left, right = xs[..., :2, :], xs[..., 2:, :]
    lidx = torch.argsort(left[..., 1], dim=-1, stable=True)
    left = torch.gather(left, -2, lidx[..., None].expand(*lidx.shape, 2))
    tl, bl = left[..., 0, :], left[..., 1, :]
    d = torch.linalg.vector_norm(right - tl[..., None, :], dim=-1)
    ridx = torch.argsort(-d, dim=-1, stable=True)
    right = torch.gather(right, -2, ridx[..., None].expand(*ridx.shape, 2))
    br, tr = right[..., 0, :], right[..., 1, :]
    return torch.stack([tl, tr, br, bl], dim=-2)


def rotate_boxes(boxes, points=False):
    """Expand rotated boxes into (axis-aligned + (sin, cos) [..., 6],
    corners [..., 8]).

    ``points=False``: boxes are (x, y, w, h, theta), the training
    targets; ``points=True``: (x1, y1, x2, y2, theta). Corners rotate
    about the box center by x' = c*dx - s*dy, y' = s*dx + c*dy (the JAX
    package's convention: its theta is the reference toolkit's -theta)
    and are put in ``order_points`` order."""
    theta = boxes[..., 4]
    c, s = torch.cos(theta), torch.sin(theta)
    if points:
        x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    else:
        x1, y1 = boxes[..., 0], boxes[..., 1]
        x2, y2 = x1 + boxes[..., 2], y1 + boxes[..., 3]
        cx, cy = x1 + boxes[..., 2] / 2, y1 + boxes[..., 3] / 2
    xs = torch.stack([x1, x2, x2, x1], dim=-1) - cx[..., None]
    ys = torch.stack([y1, y1, y2, y2], dim=-1) - cy[..., None]
    rx = c[..., None] * xs - s[..., None] * ys + cx[..., None]
    ry = s[..., None] * xs + c[..., None] * ys + cy[..., None]
    rotated = order_points(torch.stack([rx, ry], dim=-1))
    if points:
        axis_hi = torch.stack([x1 + x2 - 1, y1 + y2 - 1], -1)
    else:
        axis_hi = torch.stack([x2 - 1, y2 - 1], -1)
    boxes_axis = torch.cat([boxes[..., 0:2], axis_hi, s[..., None],
                            c[..., None]], dim=-1)
    return boxes_axis, rotated.reshape(*rotated.shape[:-2], 8)
