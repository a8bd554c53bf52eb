"""Anchor generation for RetinaNet FPN levels (numpy).

A copy of ``odtk_tpu/ops/anchors.py`` (``generate_anchors``,
``generate_anchors_rotated``, ``_order_points_np``): that module is
framework-free, but importing it runs ``odtk_tpu/ops/__init__.py``,
which imports JAX. The tests hold the two equal.

For a level of stride ``s``, anchors are (x1, y1, x2, y2) offsets
relative to the top-left of each feature cell, enumerated scale-major
then ratio-minor; rotated anchors come as an (axis-aligned, 4-corner)
pair, angle-major over those rows.
"""

import numpy as np


def generate_anchors(stride, ratios, scales):
    """Axis-aligned anchor offsets, shape [len(scales)*len(ratios), 4]:
    a base window of ``stride x stride`` reshaped per ratio (preserving
    area) and scaled, centered on the window."""
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(scales, np.float32)
    r = np.tile(ratios, len(scales))                     # ratio-minor
    s = np.repeat(scales, len(ratios))                   # scale-major
    ws = np.sqrt(stride * stride / r)
    dwh = np.stack([ws, ws * r], axis=1)                 # [N, 2]
    wh = np.full((len(r), 2), stride, np.float32)
    xy1 = 0.5 * (wh - dwh * s[:, None])
    xy2 = 0.5 * (wh + dwh * s[:, None])
    return np.concatenate([xy1, xy2], axis=1).astype(np.float32)


def _order_points_np(pts):
    """Canonicalize 4-corner boxes [N, 4, 2] to (tl, tr, br, bl): sort by
    x; the two left-most sorted by y give (tl, bl); of the two right-most,
    the farther from tl is br, the nearer tr."""
    pts = np.asarray(pts, np.float32)
    idx = np.argsort(pts[:, :, 0], axis=1, kind='stable')
    xs = np.take_along_axis(pts, idx[:, :, None], axis=1)
    left, right = xs[:, :2], xs[:, 2:]
    lidx = np.argsort(left[:, :, 1], axis=1, kind='stable')
    left = np.take_along_axis(left, lidx[:, :, None], axis=1)
    tl, bl = left[:, 0], left[:, 1]
    d = np.linalg.norm(right - tl[:, None, :], axis=2)   # [N, 2]
    ridx = np.argsort(-d, axis=1, kind='stable')
    right = np.take_along_axis(right, ridx[:, :, None], axis=1)
    br, tr = right[:, 0], right[:, 1]
    return np.stack([tl, tr, br, bl], axis=1)


def generate_anchors_rotated(stride, ratios, scales, angles):
    """Rotated anchors: the (axis-aligned [N, 4], 4-corner [N, 8]) pair.

    The (scale, ratio) table has rounded integer side lengths; corners
    are placed inclusive ([xy0, xy2] spans ``wh - 1``), rotated by each
    angle about the window center ``stride / 2 - 0.5`` with
    x' = c*dx - s*dy, and put in ``_order_points_np`` order. Rows are
    angle-major over the scale-major (scale, ratio) rows.
    """
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(scales, np.float32)
    angles = np.asarray(angles, np.float32)
    r = np.tile(ratios, len(scales))
    s = np.repeat(scales, len(ratios))
    n_rs = len(r)

    wh = np.full((n_rs, 2), stride, np.float32)
    ws = np.round(np.sqrt(stride * stride / r))
    dwh = np.stack([ws, np.round(ws * r)], axis=1)
    xy0 = 0.5 * (wh - dwh * s[:, None])                  # top-left
    xy2 = 0.5 * (wh + dwh * s[:, None]) - 1              # bottom-right
    xy1 = np.stack([xy0[:, 0], xy2[:, 1]], axis=1)       # bottom-left
    xy3 = np.stack([xy2[:, 0], xy0[:, 1]], axis=1)       # top-right

    c, si = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, -si], 1), np.stack([si, c], 1)], axis=1)

    ctr = stride / 2.0 - 0.5
    corners = []
    for xy in (xy0, xy1, xy2, xy3):
        # [n_angles, 2, n_rs] -> [n_angles * n_rs, 2] angle-major
        p = np.einsum('aij,nj->ain', rot, xy - ctr) + ctr
        corners.append(p.transpose(0, 2, 1).reshape(-1, 2))

    axis = np.concatenate([np.tile(xy0, (len(angles), 1)),
                           np.tile(xy2, (len(angles), 1))], axis=1)
    rotated = _order_points_np(np.stack(corners, axis=1)).reshape(-1, 8)
    return axis.astype(np.float32), rotated.astype(np.float32)
