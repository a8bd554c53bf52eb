"""Anchor target assignment (``snap_to_anchors``), batched.

Counterpart of ``odtk_tpu/ops/assign.py:snap_to_anchors`` with
``_axis_iou`` and ``_finalize`` (axis-aligned boxes). The JAX function
assigns one image and is vmapped over the batch; this one takes the
batch dimension directly.

Targets are padded ``[B, max_det, 5]`` rows ``(x, y, w, h, class)``;
rows of class -1 are padding. Outputs are index-form targets in the
heads' own anchor-major order, anchor n = (h * W + w) * A + a, the
memory order of an NHWC [B, H, W, A*K] head:

- cls [B, N] int32: the class of each anchor's best box, clipped to
  [0, K-1] (meaningful only where depth > 0);
- deltas [B, N, 4] fp32: ``box2delta`` of the best box;
- depth [B, N] fp32: -1 ignore (lo <= IoU < hi), 0 background
  (IoU < lo), c+1 object of class c (IoU >= hi).
"""

import torch

from .boxes import box2delta


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
    """All anchors of one level as (x1, y1, x2, y2) [H*W*A, 4] fp32,
    anchor-major: cell (h, w) top-left + each table row."""
    table = torch.as_tensor(anchor_table, dtype=torch.float32,
                            device=device)
    x = torch.arange(width, dtype=torch.float32, device=device) * stride
    y = torch.arange(height, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(y, x, indexing='ij')
    cell = torch.stack([gx, gy, gx, gy], dim=-1)          # [H, W, 4]
    return (cell[:, :, None, :] + table).reshape(-1, 4)


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

    lo, hi = anchor_ious
    depth = torch.full_like(best_iou, -1.0)
    depth = torch.where(best_iou < lo, 0.0, depth)
    depth = torch.where(best_iou >= hi, best_cls + 1.0, depth)
    cls = torch.clamp(best_cls, 0, num_classes - 1).to(torch.int32)
    return cls, deltas, depth
