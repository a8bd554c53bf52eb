"""Rotated-box (convex quad) IoU by Sutherland-Hodgman clipping: the
plain PyTorch versions.

Counterpart of ``odtk_tpu/ops/iou_rotated.py`` (``_soa_clip_iou``,
``_clip_iou_one``, ``quad_iou_one_vs_all``, ``rotated_best_match``,
``rotated_best_match_batched``, ``quad_areas``, ``sincos_box_corners``).
The JAX module's chunking and one-hot matmuls exist for XLA; here the
batch dimension is written out and the slot dimension of the clip is a
tensor dimension.

Conventions, the JAX package's:

- the subject quad is clipped against the clip quad; a subject
  coordinate equal to the clip quad's matching corner coordinate is
  padded by +0.001 first, and the areas use the raw corners;
- ``iou = inter / (union - inter)`` with ``union = area_s + area_c``;
- NaN rules: inter and union both NaN -> 1.0; inter NaN alone -> 0.0;
- a best match folds with a strict ``>``, so the first maximum wins.

The CUDA kernels (``csrc/quad_iou.cuh``) repeat the arithmetic of
``_soa_clip_iou`` operation for operation, each rounded as PyTorch
rounds it, so a kernel equals its plain version exactly.
"""

import torch

SLOTS = 8                  # most vertices of a quad-quad intersection
PAD = 0.001                # coincident-coordinate pad


def _soa_clip_iou(sx, sy, sx_raw, sy_raw, cx, cy):
    """IoU of subject polygons against clip quads, slot-parallel.

    sx, sy [8, *S]: subject vertex slots (0-3 the padded corners, 4-7
    zero); sx_raw, sy_raw [4, *S]: the raw corners (area term); cx, cy:
    4 clip-corner tensors each broadcasting against S. Returns [*S].
    The operation order is ``odtk_tpu/ops/iou_rotated.py:_soa_clip_iou``'s.
    """
    shape = sx.shape[1:]
    slot = torch.arange(SLOTS, device=sx.device).view(SLOTS,
                                                      *(1,) * len(shape))
    count = torch.full(shape, 4, dtype=torch.int64, device=sx.device)

    subj_area2 = torch.zeros(shape, dtype=sx.dtype, device=sx.device)
    for j in range(4):
        k = (j + 1) % 4
        subj_area2 = subj_area2 + (sx_raw[j] * sy_raw[k]
                                   - sy_raw[j] * sx_raw[k])

    def successor(v, count):
        # slot j's successor is slot j+1 while j+1 < count, else slot 0
        return torch.where(slot + 1 < count, torch.roll(v, -1, 0), v[:1])

    for e in range(4):
        v1x, v1y = cx[e], cy[e]
        v2x, v2y = cx[(e + 1) % 4], cy[(e + 1) % 4]
        a = v2y - v1y
        b = v1x - v2x
        c = v2x * v1y - v2y * v1x

        lv = a * sx + b * sy + c
        nx, ny, nlv = (successor(v, count) for v in (sx, sy, lv))
        in_poly = slot < count
        keep_v = in_poly & (lv <= 0)
        keep_i = in_poly & (lv * nlv <= 0)
        a2 = ny - sy
        b2 = sx - nx
        c2 = nx * sy - ny * sx
        w = a * b2 - b * a2
        ix = (b * c2 - c * b2) / w
        iy = (c * a2 - a * c2) / w

        # candidates interleaved (vertex j, intersection j), compacted in
        # that order; a NaN of a candidate that is not kept never lands
        keep = torch.stack([keep_v, keep_i], 1).reshape(2 * SLOTS, *shape)
        run = torch.cumsum(keep, 0)
        dest = torch.where(keep & (run <= SLOTS), run - 1, SLOTS)
        new = []
        for v, iv in ((sx, ix), (sy, iy)):
            cand = torch.stack([v, iv], 1).reshape(2 * SLOTS, *shape)
            cand = torch.where(keep, cand, 0.0)
            out = torch.zeros((SLOTS + 1, *shape), dtype=sx.dtype,
                              device=sx.device)
            new.append(out.scatter_(0, dest, cand)[:SLOTS])
        sx, sy = new
        count = run[-1]

    nx, ny = successor(sx, count), successor(sy, count)
    term = torch.where(slot < count, sx * ny - sy * nx, 0.0)
    inter2 = torch.zeros(shape, dtype=sx.dtype, device=sx.device)
    for j in range(SLOTS):
        inter2 = inter2 + term[j]
    inter = torch.where(count > 2, torch.abs(inter2) / 2.0, 0.0)

    clip_area2 = 0.0
    for j in range(4):
        k = (j + 1) % 4
        clip_area2 = clip_area2 + cx[j] * cy[k] - cy[j] * cx[k]
    union = torch.abs(subj_area2) / 2.0 + torch.abs(clip_area2) / 2.0
    iou = inter / (union - inter)
    both_nan = torch.isnan(inter) & torch.isnan(union)
    return torch.where(both_nan, 1.0,
                       torch.where(torch.isnan(inter), 0.0, iou))


def clip_iou(subj, cx, cy):
    """IoU of subject quads [*S, 8] against clip quads given as corner
    lists cx, cy (4 tensors each, broadcasting against S), with the
    coincidence pad. Returns [*S]."""
    sx_raw = subj[..., 0::2].movedim(-1, 0)
    sy_raw = subj[..., 1::2].movedim(-1, 0)
    sx = torch.stack([torch.where(sx_raw[k] == cx[k], sx_raw[k] + PAD,
                                  sx_raw[k]) for k in range(4)])
    sy = torch.stack([torch.where(sy_raw[k] == cy[k], sy_raw[k] + PAD,
                                  sy_raw[k]) for k in range(4)])
    zeros = torch.zeros_like(sx)
    return _soa_clip_iou(torch.cat([sx, zeros]), torch.cat([sy, zeros]),
                         sx_raw, sy_raw, cx, cy)


def _corner_lists(quads, lead):
    """Corners of quads [..., 8] as two lists of 4 tensors shaped to
    broadcast against ``lead`` trailing subject dims."""
    q = quads.reshape(*quads.shape[:-1], *(1,) * lead, 8)
    return ([q[..., 2 * k] for k in range(4)],
            [q[..., 2 * k + 1] for k in range(4)])


def quad_iou_one_vs_all(subject_quads, clip_quad):
    """IoU of N subject quads vs one clip quad: [N, 8], [8] -> [N]."""
    subj = subject_quads.reshape(-1, 8).float()
    cx, cy = _corner_lists(clip_quad.reshape(8).float(), 0)
    return clip_iou(subj, cx, cy)


def quad_areas(quads):
    """Shoelace areas of quads [..., 8] -> [...]."""
    q = quads.reshape(*quads.shape[:-1], 4, 2)
    nxt = torch.roll(q, -1, dims=-2)
    return torch.abs((q[..., 0] * nxt[..., 1]
                      - q[..., 1] * nxt[..., 0]).sum(-1)) / 2.0


def sincos_box_corners(boxes):
    """Corners [..., 8] of (x1, y1, x2, y2, sin, cos) boxes: the
    axis-aligned rectangle rotated about its center by
    R = [[cos, -sin], [sin, cos]]."""
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    s, c = boxes[..., 4:5], boxes[..., 5:6]
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    xs = torch.stack([x1, x2, x2, x1], dim=-1) - cx[..., None]
    ys = torch.stack([y1, y1, y2, y2], dim=-1) - cy[..., None]
    rx = xs * c - ys * s + cx[..., None]
    ry = ys * c + xs * s + cy[..., None]
    return torch.stack([rx, ry], dim=-1).reshape(*boxes.shape[:-1], 8)


def pack_active(clip_quads, active):
    """Per image, the active target rows first in ascending slot order:
    (rows [B, M, 9] = quad and original slot, n_act [B] int32), the
    packing ``odtk_tpu/ops/iou_rotated.py:369-374`` builds."""
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(clip_quads.float(), 1,
                          order[..., None].expand(-1, -1, 8))
    rows = torch.cat([packed, order[..., None].float()], dim=-1)
    return rows.contiguous(), active.sum(1).to(torch.int32)


def rotated_best_match_batched(subject_quads, clip_quads, valid,
                               skip_ratio=None):
    """(best_iou [B, N], best_slot [B, N] int64) of N shared subject
    quads against each image's M target quads [B, M, 8].

    A target slot is skipped when it is padding (``valid`` false) or,
    with ``skip_ratio`` (the assignment's ``lo``), when its area lies
    outside ``[lo * min(Sa), max(Sa) / lo]``, where no anchor can reach
    ``lo`` against it. Active targets are packed per image and folded in
    ascending slot order with a strict ``>`` from (-2, slot 0), by the
    matcher wrapper of ``ops/kernels/match_rotated.py``: its plain
    version on the CPU, the kernel on CUDA.
    """
    from .kernels.match_rotated import rotated_match

    best_iou, best_slot = rotated_match(*match_inputs(
        subject_quads, clip_quads, valid, skip_ratio))
    return best_iou, best_slot.long()


def rotated_best_match_levels(level_quads, clip_quads, valid,
                              skip_ratio=None):
    """``rotated_best_match_batched`` for every FPN level at once: a list
    of L subject quad tensors [N_l, 8] against each image's targets [B,
    M, 8] -> a list of L (best_iou [B, N_l], best_slot [B, N_l] int64).
    Only the size band differs by level. One matcher call (one kernel
    launch on CUDA) for all levels."""
    from .kernels.match_rotated import rotated_match_levels

    return [(iou, slot.long()) for iou, slot in rotated_match_levels(
        *match_inputs_levels(level_quads, clip_quads, valid, skip_ratio))]


def match_inputs(subject_quads, clip_quads, valid, skip_ratio=None):
    """The batched matcher's inputs: (subject quads [N, 8], packed rows
    [B, M, 9], n_act [B]), padding and out-of-band targets left out."""
    (subj,), rows, n_act = match_inputs_levels([subject_quads], clip_quads,
                                               valid, skip_ratio)
    return subj, rows[0], n_act[0]


def match_inputs_levels(level_quads, clip_quads, valid, skip_ratio=None):
    """The levels matcher's inputs: (a list of subject quads [N_l, 8],
    packed rows [L, B, M, 9], n_act [L, B]); a level leaves out the
    padding and the targets outside its size band, all levels packed in
    one pass."""
    subj = [q.reshape(-1, 8).float() for q in level_quads]
    clips = clip_quads.float()
    active = valid.bool()[None].expand(len(subj), *valid.shape)
    if skip_ratio is not None:
        clip_areas = quad_areas(clips)
        bands = []
        for s in subj:
            areas = quad_areas(s)
            amin, amax = areas.min(), areas.max()
            bands.append((clip_areas >= skip_ratio * amin)
                         & (clip_areas * skip_ratio <= amax))
        active = active & torch.stack(bands)
    levels, b, m = active.shape
    rows, n_act = pack_active(
        clips[None].expand(levels, -1, -1, -1).reshape(levels * b, m, 8),
        active.reshape(levels * b, m))
    return subj, rows.view(levels, b, m, 9), n_act.view(levels, b)


def rotated_best_match(subject_quads, clip_quads, valid):
    """(best_iou [N], best_idx [N] int64) of each subject quad vs M clip
    quads; an invalid column counts as IoU -1 (it is not skipped). The
    wrapper of ``ops/kernels/match_rotated.py``: the plain version on the
    CPU, the kernel on CUDA."""
    from .kernels.match_rotated import rotated_best_match as best_match
    best_iou, best_idx = best_match(subject_quads.reshape(-1, 8).float(),
                                    clip_quads.reshape(-1, 8).float(),
                                    valid.reshape(-1))
    return best_iou, best_idx.long()
