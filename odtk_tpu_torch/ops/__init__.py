"""Tensor ops: anchors, colour affines, box codecs, assignment, losses,
decode, NMS."""

from .anchors import generate_anchors
from .assign import snap_to_anchors
from .boxes import box2delta, delta2box
from .color import apply_color_affine, eval_normalize_u8
from .decode import decode, decode_fused
from .losses import focal_loss, smooth_l1_loss
from .nms import nms

__all__ = ['generate_anchors', 'snap_to_anchors', 'box2delta', 'delta2box',
           'apply_color_affine', 'eval_normalize_u8', 'decode',
           'decode_fused', 'focal_loss', 'smooth_l1_loss', 'nms']
