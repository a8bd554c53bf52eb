"""Rotated anchor matching: the CUDA kernels (csrc/match_rotated.cu) and
their plain PyTorch versions, for two entry points.

- ``rotated_match_levels`` replaces the TPU kernel
  ``odtk_tpu/ops/pallas/match_rotated_kernel.py:rotated_match_pallas``,
  the batched matcher of every rotated training step, for all FPN levels
  of the step in one launch: per level its anchors [N_l, 8], shared
  across the batch; per level and image the packed rows [L, B, M, 9]
  (quad and original slot, the first n_act[l, b] active, in ascending
  slot order) -> per level (best_iou [B, N_l], best_slot [B, N_l] int32),
  a strict ``>`` fold from (-2, slot 0). The plain version is the JAX
  package's stream (the jnp form of ``rotated_best_match_batched``) a
  level, with no skip. ``rotated_match`` is its one-level form.
- ``rotated_best_match`` replaces
  ``odtk_tpu/ops/pallas/iou_kernel.py:rotated_best_match_pallas`` with
  the semantics of the jnp ``rotated_best_match`` it stands for: one
  image, every target visited in order, an invalid one counting as IoU
  -1, (best_iou [N], best_idx [N] int32), any number of targets. Its
  kernel is the batched one's template run exactly: it skips the same
  pairs and lets each stand for what its clip gives (+0.0, or NaN when
  neither quad has an area), folds every IoU > -2 by (IoU descending,
  row ascending) with the first invalid row at -1, and so equals the
  plain version bit for bit (``tests/test_torch_best_match.py`` replays
  it on the CPU).

What the batched kernel and its plain version share, and where they
differ. Both clip by ``_soa_clip_iou``'s arithmetic, so each IoU they
compute is the same bit for bit. The kernel clips only the (anchor,
target) pairs whose axis-aligned boxes, widened by ``SKIP_MARGIN``, meet
or that hold a corner that is not finite or not below ``SKIP_LIMIT`` in
magnitude, or whose target is not ``convex_left`` (``clip_mask``); a
skipped pair's IoU is 0 (or NaN), never > 0. It folds each anchor's IoUs >= 0 by (IoU descending, packed row
ascending), the strict ``>`` fold's order, and an anchor that no clipped
pair reached keeps (-2, slot 0). So wherever the
plain best IoU is > 0 the kernel's equals it, IoU and slot; everywhere
else both are <= 0, below the background threshold ``lo``. So the
assignment's ``depth`` is equal everywhere, and its class and deltas
wherever ``depth > 0``: what the loss reads. ``tests/test_torch_kernels.py``
and ``chip_smoke.py`` hold the kernel to exactly that, and
``tests/test_torch_match_levels.py`` replays its skip and fold on the CPU.

The wrappers take the plain version for tensors on the CPU and the
kernel for CUDA tensors; there is no fallback between them.
"""

import ctypes

import torch

from ..iou_rotated import _corner_lists, clip_iou
from . import _build

TILE = 256                 # kThreads of csrc/match_rotated.cu: anchors a tile
MAX_LEVELS = 8             # kMaxLevels
SKIP_MARGIN = 0.25         # kSkipMargin: the widening of the AABB skip
SKIP_LIMIT = 8192.0        # kSkipLimit: larger coordinates are clipped


def rotated_match_plain(anchors, rows, n_act):
    """The stream: per image, its active rows in order, each clipped
    against every anchor and folded with a strict ``>``."""
    b, n = rows.shape[0], anchors.shape[0]
    best_iou = anchors.new_full((b, n), -2.0)
    best_slot = torch.zeros((b, n), dtype=torch.int32, device=anchors.device)
    steps = int(n_act.max()) if b else 0
    for t in range(steps):
        row = rows[:, t]                                   # [B, 9]
        cx, cy = _corner_lists(row[:, :8], 1)              # [B, 1] each
        iou = clip_iou(anchors, cx, cy)                    # [B, N]
        upd = (t < n_act.to(anchors.device))[:, None] & (iou > best_iou)
        best_iou = torch.where(upd, iou, best_iou)
        best_slot = torch.where(upd, row[:, 8:9].to(torch.int32), best_slot)
    return best_iou, best_slot


def rotated_match_levels_plain(anchors, rows, n_act):
    """``rotated_match_plain`` a level: anchors a list of [N_l, 8], rows
    [L, B, M, 9], n_act [L, B]."""
    return [rotated_match_plain(a, rows[level], n_act[level])
            for level, a in enumerate(anchors)]


def convex_left(quads):
    """[...]: whether quads [..., 8] turn left at each corner (every cross
    product of consecutive edges > 0, fp32): convex in the clip's
    orientation (``convex_left`` of csrc/match_rotated.cu)."""
    x, y = quads[..., 0::2], quads[..., 1::2]
    left = torch.ones(quads.shape[:-1], dtype=torch.bool,
                      device=quads.device)
    for j in range(4):
        k, m = (j + 1) % 4, (j + 2) % 4
        left &= ((x[..., k] - x[..., j]) * (y[..., m] - y[..., k])
                 - (y[..., k] - y[..., j]) * (x[..., m] - x[..., k])) > 0
    return left


def _boxes(quads, clip):
    """Axis-aligned boxes (lo [..., 2], hi [..., 2]) of quads [..., 8],
    widened by SKIP_MARGIN, and whether a pair of the quad may be
    skipped: all corners finite and below SKIP_LIMIT in magnitude and,
    for a clip quad (a target), ``convex_left``."""
    pts = quads.reshape(*quads.shape[:-1], 4, 2)
    skip = (quads.abs() < SKIP_LIMIT).all(-1)
    if clip:
        skip &= convex_left(quads)
    return pts.amin(-2) - SKIP_MARGIN, pts.amax(-2) + SKIP_MARGIN, skip


def clip_mask(anchors, rows, n_act):
    """[B, N, M] bool: the (image, anchor, packed row) pairs the batched
    kernel clips. A pair of an active row is clipped unless both quads'
    corners are finite and below SKIP_LIMIT in magnitude, the row is
    ``convex_left`` and their boxes, each widened by SKIP_MARGIN, are
    disjoint (csrc/match_rotated.cu)."""
    lo, hi, fin = _boxes(anchors.float(), False)           # [N, 2], [N]
    tlo, thi, tfin = _boxes(rows[..., :8].float(), True)   # [B, M, 2]
    apart = ((lo[None, :, None] > thi[:, None])
             | (tlo[:, None] > hi[None, :, None])).any(-1)  # [B, N, M]
    skip = fin[None, :, None] & tfin[:, None] & apart
    m = rows.shape[1]
    active = (torch.arange(m, device=rows.device)[None]
              < n_act.to(rows.device)[:, None])           # [B, M]
    return ~skip & active[:, None]


def level_tiles(ns):
    """The kernel's split of the levels' anchors into tiles of ``TILE``,
    in level order (a block a tile and image). Returns (each level's first
    tile, the tiles of all levels); a level of no anchors has no tile."""
    tile0, tiles = [], 0
    for n in ns:
        tile0.append(tiles)
        tiles += -(-int(n) // TILE)
    return tile0, tiles


def rotated_best_match_plain(anchors, clips, valid):
    """Best (IoU, index) of anchors [N, 8] vs clips [M, 8]; an invalid
    clip counts as IoU -1 (``odtk_tpu/ops/iou_rotated.py:230-253``)."""
    n = anchors.shape[0]
    best_iou = anchors.new_full((n,), -2.0)
    best_idx = torch.zeros(n, dtype=torch.int32, device=anchors.device)
    for i in range(clips.shape[0]):
        cx, cy = _corner_lists(clips[i], 0)
        iou = torch.where(valid[i], clip_iou(anchors, cx, cy), -1.0)
        upd = iou > best_iou
        best_iou = torch.where(upd, iou, best_iou)
        best_idx = torch.where(upd, i, best_idx)
    return best_iou, best_idx


def _check_anchors(anchors, name):
    if (anchors.device.type != 'cuda' or anchors.dim() != 2
            or anchors.shape[1] != 8):
        raise ValueError(f'{name}: anchors must be a CUDA [N, 8] tensor, got '
                         f'{tuple(anchors.shape)} on {anchors.device}')
    return anchors.float().contiguous()


def rotated_match_levels(anchors, rows, n_act):
    """Batched best match of every level: the plain version on the CPU,
    the kernel on CUDA, one launch for each group of up to
    ``MAX_LEVELS`` levels. anchors: a list of L [N_l, 8] tensors; rows
    [L, B, M, 9]; n_act [L, B] -> a list of L (best_iou [B, N_l] fp32,
    best_slot [B, N_l] int32)."""
    if anchors[0].device.type == 'cpu':
        return rotated_match_levels_plain(
            [a.float() for a in anchors], rows.float(), n_act)
    anchors = [_check_anchors(a, 'rotated_match_levels') for a in anchors]
    levels = len(anchors)
    device = anchors[0].device
    if (not levels or rows.dim() != 4
            or rows.shape[0] != levels or rows.shape[3] != 9
            or n_act.shape != rows.shape[:2] or rows.device != device
            or n_act.device != device
            or any(a.device != device for a in anchors)):
        raise ValueError(f'rotated_match_levels: {levels} levels, rows '
                         f'{tuple(rows.shape)} and n_act '
                         f'{tuple(n_act.shape)} on {rows.device}, '
                         f'{n_act.device}')
    if levels > MAX_LEVELS:
        return [out for cut in _build.level_groups(levels, MAX_LEVELS)
                for out in rotated_match_levels(
                    anchors[cut], rows[cut], n_act[cut])]
    b, m = rows.shape[1:3]
    rows = rows.float().contiguous()
    n_act = n_act.to(torch.int32).contiguous()
    ns = [a.shape[0] for a in anchors]
    best_iou = anchors[0].new_empty(b * sum(ns))
    best_slot = torch.empty(b * sum(ns), dtype=torch.int32, device=device)
    out = [(i.view(b, n), s.view(b, n)) for i, s, n in zip(
        best_iou.split([b * n for n in ns]),
        best_slot.split([b * n for n in ns]), ns)]
    tile0, tiles = level_tiles(ns)
    fields = []
    for a, (iou, slot), n, first in zip(anchors, out, ns, tile0):
        fields += [a.data_ptr(), iou.data_ptr(), slot.data_ptr(), n, first]
    table = (ctypes.c_longlong * len(fields))(*fields)
    with torch.cuda.device(device):
        rc = _build.library().odtk_match_rotated(
            table, levels, tiles, rows.data_ptr(), n_act.data_ptr(), b, m,
            _build.stream_handle(device))
    _build.check(rc, 'odtk_match_rotated')
    rotated_match_levels.launches += 1
    return out


def rotated_match(anchors, rows, n_act):
    """Batched best match of one level: ``rotated_match_levels`` of one
    (the plain version on the CPU, one launch on CUDA). anchors [N, 8],
    rows [B, M, 9], n_act [B] -> (best_iou [B, N] fp32, best_slot [B, N]
    int32)."""
    if anchors.device.type == 'cpu':
        return rotated_match_plain(anchors.float(), rows.float(), n_act)
    if rows.dim() != 3 or n_act.dim() != 1:
        raise ValueError(f'rotated_match: rows {tuple(rows.shape)} and n_act '
                         f'{tuple(n_act.shape)}')
    return rotated_match_levels([anchors], rows[None], n_act[None])[0]


def rotated_best_match(anchors, clips, valid):
    """Best match of one image: the plain version on the CPU, the kernel
    on CUDA. anchors [N, 8], clips [M, 8], valid [M] ->
    (best_iou [N] fp32, best_idx [N] int32)."""
    if anchors.device.type == 'cpu':
        return rotated_best_match_plain(anchors.float(), clips.float(),
                                        valid.bool())
    anchors = _check_anchors(anchors, 'rotated_best_match')
    m = clips.shape[0]
    if (clips.shape != (m, 8) or valid.shape != (m,)
            or clips.device != anchors.device
            or valid.device != anchors.device):
        raise ValueError(f'rotated_best_match: clips {tuple(clips.shape)}, '
                         f'valid {tuple(valid.shape)} on {clips.device}, '
                         f'{valid.device}')
    clips = clips.float().contiguous()
    valid = valid.bool().contiguous()
    n = anchors.shape[0]
    best_iou = anchors.new_empty(n)
    best_idx = torch.empty(n, dtype=torch.int32, device=anchors.device)
    if n == 0:
        return best_iou, best_idx
    with torch.cuda.device(anchors.device):
        rc = _build.library().odtk_rotated_best_match(
            anchors.data_ptr(), clips.data_ptr(), valid.data_ptr(), n, m,
            best_iou.data_ptr(), best_idx.data_ptr(),
            _build.stream_handle(anchors.device))
    _build.check(rc, 'odtk_rotated_best_match')
    rotated_best_match.launches += 1
    return best_iou, best_idx


rotated_match_levels.launches = 0
rotated_best_match.launches = 0
