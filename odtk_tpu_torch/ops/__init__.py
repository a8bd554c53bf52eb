"""Tensor ops: anchors, colour affines, box codecs, rotated-box IoU,
assignment, losses, decode, NMS."""

from .anchors import generate_anchors, generate_anchors_rotated
from .assign import (snap_to_anchors, snap_to_anchors_rotated,
                     snap_to_anchors_rotated_batched,
                     snap_to_anchors_rotated_levels)
from .boxes import (box2delta, box2delta_rotated, delta2box,
                    delta2box_rotated, order_points, rotate_boxes)
from .color import (apply_color_affine, apply_color_affine_yuv,
                    eval_normalize_u8, eval_normalize_yuv)
from .decode import decode, decode_fused
from .losses import focal_loss, smooth_l1_loss
from .nms import nms, nms_rotated

__all__ = ['generate_anchors', 'generate_anchors_rotated',
           'snap_to_anchors', 'snap_to_anchors_rotated',
           'snap_to_anchors_rotated_batched',
           'snap_to_anchors_rotated_levels', 'box2delta',
           'box2delta_rotated', 'delta2box', 'delta2box_rotated',
           'order_points', 'rotate_boxes', 'apply_color_affine',
           'apply_color_affine_yuv', 'eval_normalize_u8',
           'eval_normalize_yuv', 'decode', 'decode_fused', 'focal_loss',
           'smooth_l1_loss', 'nms', 'nms_rotated']
