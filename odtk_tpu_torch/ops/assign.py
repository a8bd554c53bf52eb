"""Anchor target assignment, axis-aligned and rotated.

Counterpart of ``odtk_tpu/ops/assign.py``: ``snap_to_anchors`` (with
``_axis_iou`` and ``_finalize``), ``snap_to_anchors_rotated_batched``
and its unbatched reference twin ``snap_to_anchors_rotated``. The JAX
``snap_to_anchors`` assigns one image and is vmapped over the batch;
the batched functions here take the batch dimension directly.
``snap_to_anchors_rotated_levels`` assigns every FPN level of a rotated
step with one matcher call, what five calls of the one-level
``snap_to_anchors_rotated_batched`` give.

Targets are padded ``[B, max_det, 5]`` rows ``(x, y, w, h, class)``, or
``[B, max_det, 6]`` rows ``(x, y, w, h, theta, class)`` when rotated;
rows of class -1 are padding. Outputs are index-form targets in the
heads' own anchor-major order, anchor n = (h * W + w) * A + a, the
memory order of an NHWC [B, H, W, A*K] head:

- cls [B, N] int32: the class of each anchor's best box, clipped to
  [0, K-1] (meaningful only where depth > 0);
- deltas [B, N, 4] fp32 (``box2delta`` of the best box), or [B, N, 6]
  rotated (``box2delta_rotated`` of its axis-aligned + (sin, cos) form
  against the axis-aligned anchor);
- depth [B, N] fp32: -1 ignore (lo <= IoU < hi), 0 background
  (IoU < lo), c+1 object of class c (IoU >= hi).
"""

import torch

from .boxes import box2delta, box2delta_rotated, rotate_boxes
from .iou_rotated import (rotated_best_match, rotated_best_match_batched,
                          rotated_best_match_levels)


def _axis_iou(anchors, boxes):
    """IoU [B, N, M] of anchors [N, 4] against boxes [B, M, 4], with the
    inclusive +1 pixel convention; the same operation order as the JAX
    function."""
    a = anchors[None, :, None, :]
    b = boxes[:, None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]) + 1, min=0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]) + 1, min=0)
    inter = iw * ih
    area_a = ((anchors[:, 2] - anchors[:, 0] + 1)
              * (anchors[:, 3] - anchors[:, 1] + 1))
    area_b = ((boxes[..., 2] - boxes[..., 0] + 1)
              * (boxes[..., 3] - boxes[..., 1] + 1))
    return inter / (area_a[None, :, None] + area_b[:, None, :] - inter)


def level_anchors(width, height, stride, anchor_table, device):
    """All anchors of one level, anchor-major: cell (h, w) top-left +
    each table row. A table [A, 4] gives (x1, y1, x2, y2) [H*W*A, 4]; a
    corner table [A, 8] gives quads [H*W*A, 8]. fp32."""
    table = torch.as_tensor(anchor_table, dtype=torch.float32,
                            device=device)
    x = torch.arange(width, dtype=torch.float32, device=device) * stride
    y = torch.arange(height, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(y, x, indexing='ij')
    reps = table.shape[-1] // 2
    cell = torch.stack([gx, gy] * reps, dim=-1)           # [H, W, 2*reps]
    return (cell[:, :, None, :] + table).reshape(-1, 2 * reps)


def _depth_and_class(best_iou, best_cls, num_classes, anchor_ious):
    """``_finalize``'s depth and index-form class."""
    lo, hi = anchor_ious
    depth = torch.full_like(best_iou, -1.0)
    depth = torch.where(best_iou < lo, 0.0, depth)
    depth = torch.where(best_iou >= hi, best_cls + 1.0, depth)
    cls = torch.clamp(best_cls, 0, num_classes - 1).to(torch.int32)
    return cls, depth


def snap_to_anchors(targets, size, stride, anchor_table, num_classes,
                    anchor_ious=(0.4, 0.5)):
    """Assign padded targets [B, max_det, 5] to the anchors of one FPN
    level. ``size`` is the level's (width, height) in pixels (cells *
    stride). Returns (cls [B, N] int32, deltas [B, N, 4], depth [B, N]).
    """
    width = int(size[0]) // int(stride)
    height = int(size[1]) // int(stride)
    targets = targets.float()
    anchors = level_anchors(width, height, stride, anchor_table,
                            targets.device)

    classes = targets[..., 4]                              # [B, M]
    valid = classes > -1
    # (x, y, w, h) -> inclusive (x1, y1, x2, y2); clamp wh so padded
    # (-1-filled) rows stay finite through the log in box2delta
    wh = torch.clamp(targets[..., 2:4], min=1e-4)
    boxes = torch.cat([targets[..., 0:2], targets[..., 0:2] + wh - 1], -1)

    overlap = torch.where(valid[:, None, :], _axis_iou(anchors, boxes), -1.0)
    m = overlap.shape[2]
    best_iou = overlap.max(dim=2).values                   # [B, N]
    # first column achieving the max: the JAX function's tie-break
    cols = torch.arange(m, dtype=torch.int32, device=targets.device)
    first = torch.where(overlap == best_iou[..., None], cols,
                        m).min(dim=2).values.long()        # [B, N]
    best_cls = torch.gather(classes, 1, first)
    best_box = torch.gather(boxes, 1, first[..., None].expand(-1, -1, 4))
    deltas = box2delta(best_box, anchors[None])
    cls, depth = _depth_and_class(best_iou, best_cls, num_classes,
                                  anchor_ious)
    return cls, deltas, depth


def rotated_targets(targets):
    """(classes, valid, axis-aligned + (sin, cos) boxes [..., M, 6],
    corner quads [..., M, 8]) of padded rotated targets [..., M, 6]
    (fp32); w and h are clamped so padded (-1-filled) rows stay finite."""
    classes = targets[..., 5]
    safe = torch.cat([targets[..., 0:2],
                      torch.clamp(targets[..., 2:4], min=1e-4),
                      targets[..., 4:5]], dim=-1)
    boxes_axis, boxes_rot = rotate_boxes(safe)
    return classes, classes > -1, boxes_axis, boxes_rot


def rotated_level_anchors(size, stride, anchor_table, device):
    """(anchors_axis [N, 4], anchor quads [N, 8]) of one level of
    (width, height) ``size`` in pixels, from the (axis, corners) table."""
    width = int(size[0]) // int(stride)
    height = int(size[1]) // int(stride)
    return tuple(level_anchors(width, height, stride, table, device)
                 for table in anchor_table)


def rotated_level(targets, size, stride, anchor_table):
    """What a rotated assignment of one level works on: (anchors_axis
    [N, 4], anchor quads [N, 8], then ``rotated_targets``' four) of
    padded rotated targets [..., M, 6] (fp32)."""
    return (*rotated_level_anchors(size, stride, anchor_table,
                                   targets.device),
            *rotated_targets(targets))


def _rotated_assignment(best_iou, best_slot, classes, boxes_axis,
                        anchors_axis, num_classes, anchor_ious):
    """(cls, deltas, depth) of one level from its best matches."""
    best_cls = torch.gather(classes, 1, best_slot)
    best_box = torch.gather(boxes_axis, 1,
                            best_slot[..., None].expand(-1, -1, 6))
    deltas = box2delta_rotated(best_box, anchors_axis[None])
    cls, depth = _depth_and_class(best_iou, best_cls, num_classes,
                                  anchor_ious)
    return cls, deltas, depth


def snap_to_anchors_rotated_batched(targets, size, stride, anchor_table,
                                    num_classes, anchor_ious=(0.4, 0.5)):
    """Assign padded rotated targets [B, max_det, 6] to the anchors of
    one FPN level. ``anchor_table`` is the (axis [A, 4], corners [A, 8])
    pair of ``generate_anchors_rotated``. Overlap is the polygon IoU of
    the rotated anchor against the rotated target, by the batched
    matcher (``rotated_best_match_batched`` with ``skip_ratio = lo``:
    padding and out-of-band targets skipped, its kernel on CUDA).
    Returns (cls [B, N] int32, deltas [B, N, 6], depth [B, N]).

    On the card the matcher's AABB skip leaves other anchors at (-2,
    slot 0) than the plain version does, all of them below ``lo`` in
    both; ``depth`` is the same, and cls and deltas wherever depth > 0
    (``ops/kernels/match_rotated.py``)."""
    anchors_axis, anchors_rot, classes, valid, boxes_axis, boxes_rot = \
        rotated_level(targets.float(), size, stride, anchor_table)
    best_iou, best_slot = rotated_best_match_batched(
        anchors_rot, boxes_rot, valid, skip_ratio=anchor_ious[0])
    return _rotated_assignment(best_iou, best_slot, classes, boxes_axis,
                               anchors_axis, num_classes, anchor_ious)


def snap_to_anchors_rotated_levels(targets, sizes, strides, anchor_tables,
                                   num_classes, anchor_ious=(0.4, 0.5)):
    """``snap_to_anchors_rotated_batched`` of every FPN level at once:
    padded rotated targets [B, max_det, 6]; per level its (width, height)
    in pixels, stride and (axis, corners) anchor table. The targets are
    rotated and packed once and every level is matched by one matcher
    call (``rotated_best_match_levels``: one kernel launch on CUDA).
    Returns (cls_ts, box_ts, depths): lists a level of [B, N_l] int32,
    [B, N_l, 6] and [B, N_l], equal to the one-level function's."""
    targets = targets.float()
    classes, valid, boxes_axis, boxes_rot = rotated_targets(targets)
    anchors = [rotated_level_anchors(size, stride, table, targets.device)
               for size, stride, table in zip(sizes, strides, anchor_tables)]
    best = rotated_best_match_levels([rot for _, rot in anchors], boxes_rot,
                                     valid, skip_ratio=anchor_ious[0])
    levels = [_rotated_assignment(iou, slot, classes, boxes_axis, axis,
                                  num_classes, anchor_ious)
              for (iou, slot), (axis, _) in zip(best, anchors)]
    return tuple(list(parts) for parts in zip(*levels))


def snap_to_anchors_rotated(targets, size, stride, anchor_table, num_classes,
                            anchor_ious=(0.4, 0.5)):
    """The unbatched reference twin of ``snap_to_anchors_rotated_batched``
    for one image's targets [max_det, 6]: every target is visited (an
    invalid one counts as IoU -1, none is skipped), by
    ``rotated_best_match`` (its kernel on CUDA). Returns (cls [N] int32,
    deltas [N, 6], depth [N])."""
    anchors_axis, anchors_rot, classes, valid, boxes_axis, boxes_rot = \
        rotated_level(targets.float(), size, stride, anchor_table)
    best_iou, best = rotated_best_match(anchors_rot, boxes_rot, valid)
    deltas = box2delta_rotated(boxes_axis[best], anchors_axis)
    cls, depth = _depth_and_class(best_iou, classes[best], num_classes,
                                  anchor_ious)
    return cls, deltas, depth
