"""The unbatched rotated matcher's kernel design (csrc/match_rotated.cu,
``match_kernel<true>``, row 8 of the kernel table) replayed on the CPU.

The kernel runs the batched matcher's template exactly: it skips a pair
only when both quads' corners are finite and below 8192 in magnitude,
the target turns left at every corner (convex, not of collinear corners)
and their axis-aligned boxes, each widened by 0.25, are disjoint, and lets
the pair stand for what its clip gives there (+0.0 where the two half
areas sum to more than 0, NaN where neither quad has an area); it folds
every IoU > -2 by (IoU descending, row ascending), the first invalid row
counting as -1, and leaves (-2, 0) where nothing was folded.
``replay_best_match`` repeats that on the CPU. The tests hold it bit for
bit to ``rotated_best_match_plain`` (the strict ``>`` fold over every
row), on degenerate inputs: zero-area and NaN quads, infinite and huge
corners, touching boxes, ties, invalid rows before and between valid ones,
m = 33 and m = 200, n not a multiple of 256. Against the JAX package's
jnp ``rotated_best_match`` and ``rotated_best_match_pallas`` in interpret
mode they agree within 1e-5 wherever IoU > 0 (XLA on the CPU may contract
a multiply and an add into one fused multiply-add, so the two packages'
IoUs differ by ~1e-7, not bit for bit). The card's test of the kernel is
in ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops import iou_rotated as jax_iou
from odtk_tpu.ops.pallas.iou_kernel import rotated_best_match_pallas
from odtk_tpu_torch.ops import rotate_boxes
from odtk_tpu_torch.ops.iou_rotated import _corner_lists, clip_iou
from odtk_tpu_torch.ops.kernels import match_rotated as kmatch
from rotated_cases import degenerate_case
from torch_threads import one_torch_thread  # noqa: F401

SKIP_MARGIN = 0.25          # kSkipMargin of csrc/match_rotated.cu
SKIP_LIMIT = 8192.0         # kSkipLimit


def _half_areas(q):
    """(subject, clip) half areas of quads [..., 8], each summed in the
    order the clip sums it (csrc/quad_iou.cuh)."""
    x, y = q[..., 0::2], q[..., 1::2]
    subj = torch.zeros(q.shape[:-1])
    clip = torch.zeros(q.shape[:-1])
    for j in range(4):
        k = (j + 1) % 4
        subj = subj + (x[..., j] * y[..., k] - y[..., j] * x[..., k])
        clip = clip + x[..., j] * y[..., k] - y[..., j] * x[..., k]
    return subj.abs() / 2.0, clip.abs() / 2.0


def skipped(anchors, clips):
    """[N, M]: the pair goes unclipped: both quads finite and below
    SKIP_LIMIT, the row ``convex_left`` (not of collinear corners), their
    widened boxes disjoint."""
    a = anchors.reshape(-1, 4, 2)
    t = clips.reshape(-1, 4, 2)
    lo, hi = a.amin(1) - SKIP_MARGIN, a.amax(1) + SKIP_MARGIN
    tlo, thi = t.amin(1) - SKIP_MARGIN, t.amax(1) + SKIP_MARGIN
    apart = ((lo[:, None] > thi[None]) | (tlo[None] > hi[:, None])).any(-1)
    small = (anchors.abs() < SKIP_LIMIT).all(-1)[:, None]
    t_small = ((clips.abs() < SKIP_LIMIT).all(-1)
               & kmatch.convex_left(clips))[None]
    return small & t_small & apart


def all_ious(anchors, clips):
    """[N, M]: every anchor (the subject) clipped against every row."""
    return torch.stack([clip_iou(anchors, *_corner_lists(clips[t], 0))
                        for t in range(clips.shape[0])], -1)


def stand_in(anchors, clips):
    """[N, M]: what a skipped pair stands for, 0 / (the half areas'
    sum): +0.0, or NaN where neither quad has an area."""
    half_s, _ = _half_areas(anchors)
    _, half_c = _half_areas(clips)
    uni = half_s[:, None] + half_c[None]
    return torch.where(uni > 0, 0.0, torch.nan)


def replay_best_match(anchors, clips, valid):
    """The kernel on the CPU: each valid row's IoU (the stand-in where the
    pair is skipped), -1 for an invalid row, folded by (value descending,
    row ascending) over the values > -2; (-2, 0) where there is none."""
    m = clips.shape[0]
    skip = skipped(anchors, clips)
    val = torch.where(skip, stand_in(anchors, clips), all_ious(anchors, clips))
    val = torch.where(valid[None], val, -1.0)
    cand = val > -2                                  # NaN never enters
    val = torch.where(cand, val, -torch.inf)
    best = val.max(-1).values
    first = torch.where(cand & (val == best[:, None]), torch.arange(m),
                        m).min(-1).values
    reached = cand.any(-1)
    return (torch.where(reached, best + 0.0, -2.0),
            torch.where(reached, first, 0).int())


def _equal(got, want):
    """IoU bit for bit (NaN nowhere), index equal."""
    assert not torch.isnan(got[0]).any()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize('m, invalid', [(33, True), (200, True),
                                        (33, False)])
def test_replay_equals_plain_bit_for_bit(m, invalid):
    """The skip, the stand-ins and the fold give the plain fold's (IoU,
    index) bit for bit; a quarter of the pairs or more are skipped (the
    targets are dense on this small canvas)."""
    anchors, clips, valid = degenerate_case(m, invalid=invalid)
    got = replay_best_match(anchors, clips, valid)
    want = kmatch.rotated_best_match_plain(anchors, clips, valid)
    _equal(got, want)
    assert skipped(anchors, clips)[:, valid].float().mean() > 0.25
    assert anchors.shape[0] % 256
    assert (got[0] > 0.5).any() and (got[0] == 0).any()


def test_fold_tails():
    """An anchor that no valid row reaches with an IoU > -2 (a NaN corner:
    every clip NaN) ends at the first invalid row, -1, and at (-2, 0)
    where every row is valid; the replay and the plain fold agree."""
    _, clips = rotate_boxes(torch.tensor([
        [10.0, 20, 30, 40, 0.3], [50, 20, 30, 40, -0.5], [5, 5, 20, 20, 0.2],
        [30, 30, 10, 10, 0.0]]))
    anchors = torch.tensor([[20.0, 20, 40, 20, 40, 40, 20, 40]] * 2)
    anchors[0, 3] = float('nan')
    for valid, tail in (([False, True, False, True], -1.0), ([True] * 4, -2.0)):
        valid = torch.tensor(valid)
        got = replay_best_match(anchors, clips, valid)
        _equal(got, kmatch.rotated_best_match_plain(anchors, clips, valid))
        assert got[0][0] == tail and got[1][0] == 0 and got[0][1] > 0


def random_convex_case(n_rows=300, seed=1):
    """The degenerate case's anchors against convex quads of every shape
    (4 points drawn around a center and sorted by angle): thin, acute,
    large and small."""
    rng = np.random.RandomState(seed)
    anchors = degenerate_case(33)[0][:-4]
    center = rng.uniform(-20, 120, (n_rows, 1, 2))
    radius = np.exp(rng.uniform(np.log(0.5), np.log(60), (n_rows, 4, 1)))
    angle = np.sort(rng.uniform(0, 2 * np.pi, (n_rows, 4)), -1)[..., None]
    pts = center + radius * np.concatenate([np.cos(angle), np.sin(angle)], -1)
    clips = torch.from_numpy(pts.reshape(n_rows, 8).astype(np.float32))
    return anchors, clips[kmatch.convex_left(clips)]


@pytest.mark.parametrize('case', ['degenerate', 'random_convex'])
def test_skipped_pairs_stand_for_their_clip(case):
    """Each skipped pair's clip gives exactly its stand-in, +0.0; rows of
    collinear corners (zero area), non-finite and huge quads and touching
    boxes are never skipped."""
    if case == 'degenerate':
        anchors, clips, _ = degenerate_case(33)
    else:
        anchors, clips = random_convex_case()
        assert clips.shape[0] > 100
    skip = skipped(anchors, clips)
    iou = all_ious(anchors, clips)
    want = stand_in(anchors, clips)
    assert skip.sum() > 10000
    assert torch.equal(iou[skip].view(torch.int32),
                       want[skip].view(torch.int32))
    if case == 'degenerate':
        n = anchors.shape[0]
        assert not skip[:, 3:8].any() and not skip[n - 2:].any()
        assert not skip[255, 8]                              # touching


def test_fold_ties_and_invalid_rows():
    """Rows 1 and 12 are one quad: row 1 wins where it is the best; an
    anchor no valid row reaches with IoU >= 0 ends at the first invalid
    row, -1."""
    anchors, clips, valid = degenerate_case(33)
    got = replay_best_match(anchors, clips, valid)
    tie = all_ious(anchors, clips)[:, 1] == got[0]
    assert tie.any() and (got[1][tie & (got[0] > 0)] <= 1).all()
    assert not (got[1] == 12).any()
    want = kmatch.rotated_best_match_plain(anchors, clips, valid)
    assert torch.equal(got[1][got[0] == -1], want[1][want[0] == -1])


def test_replay_matches_jax_stream_and_pallas():
    """The replay against the JAX jnp ``rotated_best_match`` and
    ``rotated_best_match_pallas`` in interpret mode on the same inputs,
    the degenerate rows replaced by a proper one: IoU within 1e-5 and the same index wherever theirs is > 0;
    the replay <= 0 wherever the Pallas kernel (which skips tiles and
    leaves -2) is not > 0."""
    anchors, clips, valid = degenerate_case(33)
    proper = kmatch.convex_left(clips) & (clips.abs() < SKIP_LIMIT).all(-1)
    clips = torch.where(proper[:, None], clips, clips[1])
    anchors = anchors[:-2]
    got = replay_best_match(anchors, clips, valid)
    args = (jnp.asarray(anchors.numpy()), jnp.asarray(clips.numpy()),
            jnp.asarray(valid.numpy()))
    stream = [torch.from_numpy(np.asarray(a))
              for a in jax_iou.rotated_best_match(*args)]
    pallas = [torch.from_numpy(np.asarray(a))
              for a in rotated_best_match_pallas(*args, interpret=True)]
    for want in (stream, pallas):
        hit = want[0] > 0
        assert hit.sum() > 100
        np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[1][hit], want[1][hit])
    assert (got[0][~(pallas[0] > 0)] <= 1e-5).all()
