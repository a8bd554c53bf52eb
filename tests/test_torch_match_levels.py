"""The rotated matcher's one-launch design (csrc/match_rotated.cu) replayed
on the CPU, and the levels form of the rotated assignment.

The kernel clips an (anchor, target) pair only when the two quads' axis-
aligned boxes, each widened by 0.25, meet, when a corner is not finite or
not below 8192 in magnitude, or when the target's corners are collinear;
it folds each anchor's IoUs >= 0 by (IoU descending, packed row
ascending) and leaves an anchor that no clipped pair reached at (-2, slot
0). ``replay_match`` below repeats that on the CPU; the tests hold it to
the plain stream (``rotated_match_plain``) and to the JAX package's
``rotated_best_match_batched`` (its jnp stream, and ``rotated_match_pallas``
in interpret mode) under the matcher's contract: equal IoU and slot
wherever the reference's best IoU is > 0, <= 0 elsewhere. Then
``snap_to_anchors_rotated_levels`` (all levels, one matcher call) against
five calls of the one-level ``snap_to_anchors_rotated_batched``, and the
kernel's grid over ragged levels.

IoUs of the two packages agree to ~1e-5, not bit for bit (XLA on the CPU
may contract a multiply and an add into one fused multiply-add), so the
JAX comparisons hold IoUs within 1e-5; the port's plain stream and the
replay share the clip and are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops import iou_rotated as jax_iou
from odtk_tpu.ops.pallas.match_rotated_kernel import rotated_match_pallas
from odtk_tpu_torch.ops import (generate_anchors_rotated, rotate_boxes,
                                snap_to_anchors_rotated_batched,
                                snap_to_anchors_rotated_levels)
from odtk_tpu_torch.ops.assign import level_anchors
from odtk_tpu_torch.ops.iou_rotated import (_corner_lists, clip_iou,
                                            match_inputs, match_inputs_levels,
                                            pack_active)
from odtk_tpu_torch.ops.kernels import match_rotated as kmatch

SKIP_MARGIN = 0.25          # kSkipMargin of csrc/match_rotated.cu
SKIP_LIMIT = 8192.0         # kSkipLimit
TILE = 256                  # anchors a block
RATIOS = [1.0, 2.0, 0.5]
SCALES = [4 * 2 ** (i / 3) for i in range(3)]
ANGLES = [-np.pi / 6, 0, np.pi / 6]
STRIDES = [8, 16, 32, 64, 128]


@pytest.fixture(scope='module', autouse=True)
def _one_target_per_stream_step():
    """The JAX stream's chunk only sets how many targets one step of its
    while loop clips; at 1 the graph it compiles is 8x smaller and the
    fold gives the same maxima."""
    patch = pytest.MonkeyPatch()
    patch.setenv('ODTK_ROTATED_CHUNK', '1')
    yield
    patch.undo()


def skipped(anchors, rows):
    """[B, N, M]: the pair may go unclipped: both quads' corners finite
    and below SKIP_LIMIT in magnitude, the row convex (``convex_left``:
    not of collinear corners), and their axis-aligned boxes, each widened
    by SKIP_MARGIN, disjoint."""
    a = anchors.reshape(-1, 4, 2)
    t = rows[..., :8].reshape(*rows.shape[:2], 4, 2)
    lo, hi = a.amin(1) - SKIP_MARGIN, a.amax(1) + SKIP_MARGIN     # [N, 2]
    tlo, thi = t.amin(2) - SKIP_MARGIN, t.amax(2) + SKIP_MARGIN   # [B, M, 2]
    apart = ((lo[None, :, None] > thi[:, None])
             | (tlo[:, None] > hi[None, :, None])).any(-1)
    finite = (anchors.abs() < SKIP_LIMIT).all(-1)[None, :, None]
    t_finite = ((rows[..., :8].abs() < SKIP_LIMIT).all(-1)
                & kmatch.convex_left(rows[..., :8]))[:, None]
    return finite & t_finite & apart


def all_ious(anchors, rows):
    """[B, N, M]: every anchor (the subject) clipped against every row."""
    return torch.stack([clip_iou(anchors, *_corner_lists(rows[:, t, :8], 1))
                        for t in range(rows.shape[1])], -1)


def replay_match(anchors, rows, n_act):
    """The kernel on the CPU: the clipped pairs of the active rows, their
    IoUs >= 0 folded by (IoU descending, row ascending); (-2, 0) where no
    clipped pair reached the anchor."""
    m = rows.shape[1]
    iou = all_ious(anchors, rows)
    active = torch.arange(m)[None] < n_act[:, None]               # [B, M]
    cand = active[:, None] & ~skipped(anchors, rows) & (iou >= 0)
    val = torch.where(cand, iou, -torch.inf)
    best = val.max(-1).values
    first = torch.where(cand & (val == best[..., None]), torch.arange(m),
                        m).min(-1).values
    reached = cand.any(-1)
    slot = torch.gather(rows[..., 8], 1, first.clamp(max=m - 1)).int()
    return (torch.where(reached, best + 0.0, -2.0),
            torch.where(reached, slot, 0))


def _contract(got, want, atol=0.0):
    """Equal IoU (within atol) and slot where want's IoU is > 0; got's IoU
    <= atol elsewhere."""
    hit = want[0] > 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=0, atol=atol)
    np.testing.assert_array_equal(got[1][hit], want[1][hit])
    assert (got[0][~hit] <= atol).all()


def match_case(size=(128, 96), stride=8, seed=0):
    """One level's anchor quads and packed rows of 3 images: 7 random
    targets, none, and 10 with two of them touching anchors exactly and
    one outside the size band."""
    rng = np.random.RandomState(seed)
    table = generate_anchors_rotated(stride, RATIOS, SCALES, ANGLES)
    anchors = level_anchors(size[0] // stride, size[1] // stride, stride,
                            table[1], 'cpu')
    t = np.full((3, 10, 6), -1.0, np.float32)
    for i, k in enumerate([7, 0, 10]):
        t[i, :k, :2] = rng.uniform(0, size[0] - 40, (k, 2))
        t[i, :k, 2:4] = rng.uniform(24, 60, (k, 2))
        t[i, :k, 4] = rng.uniform(-np.pi / 4, np.pi / 4, k)
        t[i, :k, 5] = rng.randint(0, 3, k)
    # axis-aligned targets whose left edge is the right edge of the anchor
    # box ending a tile of 256, and whose top edge is an anchor's bottom
    q = anchors.reshape(-1, 4, 2)
    for r, (i, axis) in enumerate([(TILE - 1, 0), (2 * TILE, 1)]):
        edge = float(q[i, :, axis].max())
        t[2, r, :5] = [edge, 20.0, 30.0, 25.0, 0.0] if axis == 0 else \
            [40.0, edge, 25.0, 30.0, 0.0]
    t[2, 9, 2:4] = [900, 900]
    _, quads = rotate_boxes(torch.from_numpy(t[..., :5]))
    subj, rows, n_act = match_inputs(anchors, quads,
                                     torch.from_numpy(t[..., 5] > -1), 0.4)
    return subj, rows, n_act, t


def test_replay_holds_the_plain_contract():
    """The skip and the fold give the plain stream's best wherever it is
    > 0, exactly; they skip most far pairs; the anchors that no clipped
    pair reached are at -2, more than the stream leaves there."""
    subj, rows, n_act, _ = match_case()
    assert n_act.tolist() == [7, 0, 9]
    got = replay_match(subj, rows, n_act)
    want = kmatch.rotated_match_plain(subj, rows, n_act)
    _contract(got, want)
    assert torch.equal(got[0][1], torch.full_like(got[0][1], -2.0))
    assert (got[0] == -2).sum() > (want[0] == -2).sum()
    skip = skipped(subj, rows)[:, :, :int(n_act.max())]
    assert skip.float().mean() > 0.5


def test_touching_pairs_are_clipped():
    """A target whose box edge is an anchor's box edge is clipped against
    it (inside the margin); boxes 0.6 apart are skipped, 0.4 apart not."""
    subj, rows, n_act, _ = match_case()
    q = subj.reshape(-1, 4, 2)
    t = rows[2, :2, :8].reshape(2, 4, 2)
    for row, (i, axis) in enumerate([(TILE - 1, 0), (2 * TILE, 1)]):
        assert t[row, :, axis].min() == q[i, :, axis].max()
        assert not skipped(subj, rows)[2, i, row]
    base = torch.tensor([100.0, 100, 120, 100, 120, 110, 100, 110])
    for gap, want in ((0.6, True), (0.4, False)):
        other = base.clone()
        other[0::2] += 20.0 + gap
        rows = torch.cat([other, torch.zeros(1)])[None, None]
        assert bool(skipped(base[None], rows)[0, 0, 0]) == want


def test_clip_mask_is_the_skip_rule():
    """``clip_mask``, which ``chip_smoke.py`` counts the kernel's clips
    with, is the replay's rule on the active rows."""
    subj, rows, n_act, _ = match_case()
    active = torch.arange(rows.shape[1])[None] < n_act[:, None]
    want = active[:, None] & ~skipped(subj, rows)
    assert torch.equal(kmatch.clip_mask(subj, rows, n_act), want)


def test_nonfinite_rows_are_clipped_and_never_win():
    """A row with a NaN or an infinite corner is clipped against every
    anchor (no skip), and its NaN IoUs never enter the fold: the replay
    still holds the stream's contract."""
    subj, rows, n_act, _ = match_case()
    rows = rows.clone()
    rows[0, 1, 0] = float('nan')
    rows[0, 2, 3] = float('inf')
    assert not skipped(subj, rows)[0, :, 1:3].any()
    got = replay_match(subj, rows, n_act)
    want = kmatch.rotated_match_plain(subj, rows, n_act)
    _contract(got, want)


def test_replay_matches_jax_stream_and_pallas():
    """The replay against the JAX jnp stream (packing its own actives
    from the same targets) and against ``rotated_match_pallas`` in
    interpret mode on the same packed rows, each under the contract."""
    subj, rows, n_act, t = match_case()
    got = replay_match(subj, rows, n_act)
    _, quads = rotate_boxes(torch.from_numpy(t[..., :5]))
    stream = [torch.from_numpy(np.asarray(a)) for a in
              jax_iou.rotated_best_match_batched(
                  jnp.asarray(subj.numpy()), jnp.asarray(quads.numpy()),
                  jnp.asarray(t[..., 5] > -1), skip_ratio=0.4,
                  use_pallas=False)]
    _contract(got, stream, atol=1e-5)
    pallas = [torch.from_numpy(np.asarray(a)) for a in rotated_match_pallas(
        jnp.asarray(subj.numpy()), jnp.asarray(rows.numpy()),
        jnp.asarray(n_act.numpy()), interpret=True)]
    _contract(got, pallas, atol=1e-5)


def levels_case(size=(256, 192), seed=1):
    rng = np.random.RandomState(seed)
    t = np.full((3, 12, 6), -1.0, np.float32)
    for i, k in enumerate([9, 0, 12]):
        t[i, :k, :2] = rng.uniform(0, size[0] - 60, (k, 2))
        t[i, :k, 2:4] = rng.uniform(6, 150, (k, 2))
        t[i, :k, 4] = rng.uniform(-np.pi / 3, np.pi / 3, k)
        t[i, :k, 5] = rng.randint(0, 3, k)
    sizes = [(size[0] // s * s, size[1] // s * s) for s in STRIDES]
    tables = [generate_anchors_rotated(s, RATIOS, SCALES, ANGLES)
              for s in STRIDES]
    return torch.from_numpy(t), sizes, tables


def test_levels_assignment_equals_five_one_level_calls():
    """All five levels through one matcher call give what five calls of
    the one-level assignment give, bit for bit; the packed rows of each
    level are the one-level packing's, the size band differing by level
    and the image without targets at n_act 0 on every level."""
    targets, sizes, tables = levels_case()
    cls_ts, box_ts, depths = snap_to_anchors_rotated_levels(
        targets, sizes, STRIDES, tables, 3)
    assert len(cls_ts) == len(box_ts) == len(depths) == 5
    fg = 0
    for lvl, (size, stride, table) in enumerate(zip(sizes, STRIDES, tables)):
        cls, deltas, depth = snap_to_anchors_rotated_batched(
            targets, size, stride, table, 3)
        assert torch.equal(cls_ts[lvl], cls)
        assert torch.equal(box_ts[lvl], deltas)
        assert torch.equal(depths[lvl], depth)
        fg += int((depth > 0).sum())
    assert fg > 0

    _, quads = rotate_boxes(torch.cat(
        [targets[..., :2], targets[..., 2:4].clamp(min=1e-4),
         targets[..., 4:5]], -1))
    valid = targets[..., 5] > -1
    anchors = [level_anchors(w // s, h // s, s, tb[1], 'cpu')
               for (w, h), s, tb in zip(sizes, STRIDES, tables)]
    subj, rows, n_act = match_inputs_levels(anchors, quads, valid, 0.4)
    for lvl, a in enumerate(anchors):
        s1, r1, n1 = match_inputs(a, quads, valid, 0.4)
        assert torch.equal(subj[lvl], s1) and torch.equal(rows[lvl], r1)
        assert torch.equal(n_act[lvl], n1)
    assert (n_act[:, 1] == 0).all() and len(set(n_act[:, 2].tolist())) > 1


def test_levels_matcher_plain_is_the_stream_a_level():
    """``rotated_match_levels`` on CPU tensors: the plain stream of each
    level."""
    targets, sizes, tables = levels_case()
    _, quads = rotate_boxes(targets[..., :5].clamp(min=-1))
    anchors = [level_anchors(w // s, h // s, s, tb[1], 'cpu')
               for (w, h), s, tb in zip(sizes[3:], STRIDES[3:], tables[3:])]
    subj, rows, n_act = match_inputs_levels(anchors, quads,
                                            targets[..., 5] > -1)
    got = kmatch.rotated_match_levels(subj, rows, n_act)
    for lvl, (iou, slot) in enumerate(got):
        want = kmatch.rotated_match_plain(subj[lvl], rows[lvl], n_act[lvl])
        assert torch.equal(iou, want[0]) and torch.equal(slot, want[1])


@pytest.mark.parametrize('ns', [[20736, 5184, 1296, 324, 81],
                                [256, 0, 257, 1, 0, 511, 512, 3]])
def test_level_tiles_cover_every_anchor_once(ns):
    """The kernel's grid over ragged levels (levels of no anchors, sizes
    off a multiple of 256), a block a (tile, image), the images of a tile
    adjacent: each block's tile is in the last level whose first tile it
    has reached (the kernel's level_of), and the blocks cover each level's
    anchors exactly once an image."""
    batch = 3
    tile0, tiles = kmatch.level_tiles(ns)
    assert tiles == sum(-(-n // TILE) for n in ns)
    seen = [torch.zeros(batch, n, dtype=torch.int64) for n in ns]
    for blk in range(tiles * batch):
        b, tile = blk % batch, blk // batch
        level = max(i for i in range(len(ns)) if tile0[i] <= tile)
        start = (tile - tile0[level]) * TILE
        assert start < ns[level]
        seen[level][b, start:start + TILE] += 1
    assert all((s == 1).all() for s in seen)


def test_pack_active_keeps_slot_order():
    """Actives first, in ascending slot order, with their original slot in
    column 8: the order the fold breaks ties by."""
    quads = torch.arange(2 * 5 * 8, dtype=torch.float32).view(2, 5, 8)
    active = torch.tensor([[False, True, False, True, True],
                           [False, False, False, False, False]])
    rows, n_act = pack_active(quads, active)
    assert n_act.tolist() == [3, 0]
    assert rows[0, :3, 8].tolist() == [1.0, 3.0, 4.0]
    assert torch.equal(rows[0, 0, :8], quads[0, 1])
