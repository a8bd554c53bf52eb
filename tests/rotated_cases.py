"""Degenerate inputs of the unbatched rotated matcher (row 8), shared by
``tests/test_torch_best_match.py`` (the kernel's design replayed on the
CPU) and ``tests/test_torch_kernels.py`` (the kernel on the card). It
imports no JAX."""

import numpy as np
import torch

from odtk_tpu_torch.ops import generate_anchors_rotated, rotate_boxes
from odtk_tpu_torch.ops.assign import level_anchors


def degenerate_case(m, seed=0, invalid=True):
    """Rotated anchors of a 96 x 72 canvas at stride 8 (2916, not a
    multiple of 256) and 4 more (a point near the targets, a point far
    from them, a NaN corner, a huge corner), against m rows: random
    rotated targets, a zero-area row on the near point and one far away,
    a NaN row, an infinite row, a huge row, a row whose box edge is an
    anchor's box edge, a row equal to an anchor (the pad), a copy of an
    earlier row (a tie); with `invalid`, row 0 and rows between the valid
    ones invalid."""
    rng = np.random.RandomState(seed)
    table = generate_anchors_rotated(8, [1.0, 2.0, 0.5],
                                     [4 * 2 ** (i / 3) for i in range(3)],
                                     [-np.pi / 6, 0, np.pi / 6])
    anchors = level_anchors(12, 9, 8, table[1], 'cpu')
    point = torch.tensor([40.0, 30.0] * 4)
    extra = torch.stack([point, torch.full((8,), 500.0), point, point])
    extra[2, 3] = float('nan')
    extra[3, 0] = 9000.0
    anchors = torch.cat([anchors, extra])
    t = np.zeros((m, 5), np.float32)
    t[:, :2] = rng.uniform(-10, 90, (m, 2))
    t[:, 2:4] = rng.uniform(4, 50, (m, 2))
    t[:, 4] = rng.uniform(-np.pi / 4, np.pi / 4, m)
    _, clips = rotate_boxes(torch.from_numpy(t))
    q = anchors.reshape(-1, 4, 2)
    edge = float(q[255, :, 0].max())
    special = torch.stack([
        point,                                     # zero area, near
        torch.full((8,), -300.0),                  # zero area, far
        torch.tensor([20.0, 20, float('nan'), 20, 40, 40, 20, 40]),
        torch.tensor([20.0, 20, float('inf'), 20, 40, 40, 20, 40]),
        torch.tensor([9000.0, 20, 9020, 20, 9020, 40, 9000, 40]),
        torch.tensor([edge, 20, edge + 30, 20, edge + 30, 45, edge, 45]),
        anchors[700].clone(),                      # the pad
    ])
    clips[3:3 + len(special)] = special
    clips[12] = clips[1]                           # a tie
    valid = torch.ones(m, dtype=torch.bool)
    if invalid:
        valid[0] = False
        valid[torch.from_numpy(rng.rand(m) < 0.25)] = False
        valid[1] = valid[3:12] = True
    return anchors, clips, valid
