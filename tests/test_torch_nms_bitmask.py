"""The rotated NMS kernel's algorithm (csrc/nms_rotated.cu), written out in
plain torch here, against the greedy rounds it replaces.

The kernel ranks the live candidates by counting (score descending, index
ascending), builds a pairwise suppression bitmask over 64-rank words with
an axis-aligned skip rule, and scans it a 64-rank chunk at a time; an
image holding a NaN score ranks no candidate (the greedy
rounds record nothing for it). ``bitmask_nms`` below repeats those three
steps on the CPU; the tests hold it equal to ``nms_rotated_plain`` (the
greedy rounds) and to the JAX package's
``odtk_tpu/ops/nms.py:nms_rotated``, and check that the skip rule never
skips a pair that overlaps.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from odtk_tpu.ops.nms import nms_rotated as jax_nms_rotated
from odtk_tpu_torch.ops.iou_rotated import (_corner_lists, clip_iou,
                                            sincos_box_corners)
from odtk_tpu_torch.ops.kernels.nms_rotated import nms_rotated_plain
from torch_threads import one_torch_thread  # noqa: F401

SKIP_MARGIN = 0.25          # kSkipMargin of csrc/nms_rotated.cu
WORD = 64                   # ranks per mask word
FULL = (1 << WORD) - 1
NDET = 100

_jax_nms = jax.jit(functools.partial(jax_nms_rotated, nms_thresh=0.5,
                                     ndetections=NDET, use_pallas=False))


def _rank_order(s):
    """The live candidates (score > 0) in the scan order, by counting: a
    candidate's rank is the number of live ones that precede it. None
    where any score is NaN (the rank step's per-image flag)."""
    if torch.isnan(s).any():
        return torch.zeros(0, dtype=torch.long)
    idx = torch.arange(s.shape[0])
    live = s > 0
    precedes = ((s[None, :] > s[:, None])
                | ((s[None, :] == s[:, None]) & (idx[None, :] < idx[:, None])))
    rank = (precedes & live[None, :]).sum(1)       # [j]: over i
    order = torch.empty(int(live.sum()), dtype=torch.long)
    order[rank[live]] = idx[live]
    return order


def skipped(q):
    """[i, j]: the clip of the pair may be skipped: both quads finite and
    their axis-aligned boxes, widened by SKIP_MARGIN, disjoint."""
    pts = q.reshape(-1, 4, 2)
    lo = pts.amin(1) - SKIP_MARGIN
    hi = pts.amax(1) + SKIP_MARGIN
    finite = torch.isfinite(q).all(-1)
    apart = ((lo[None, :] > hi[:, None]) | (lo[:, None] > hi[None, :])).any(-1)
    return finite[:, None] & finite[None, :] & apart


def _mask_words(q, cls, thr):
    """Row i's words: bit j set iff i is ranked before j, same class,
    not skipped and quad_iou(subject j, clip i) > thr."""
    n = q.shape[0]
    cx, cy = _corner_lists(q, 1)                          # clip i on dim 0
    iou = clip_iou(q[None].expand(n, n, 8), cx, cy)       # [i, j]
    bits = ((cls[:, None] == cls[None, :])
            & torch.ones(n, n, dtype=torch.bool).triu(1)
            & ~skipped(q) & (iou > thr))
    words = -(-n // WORD)
    rows = []
    for i in range(n):
        row = [0] * words
        for j in torch.nonzero(bits[i]).flatten().tolist():
            row[j // WORD] |= 1 << (j % WORD)
        rows.append(row)
    return rows


def _scan(rows, n, ndet):
    """The kept ranks, a 64-rank chunk (one mask word) at a time: within
    chunk c keep the first open rank and OR its diagonal word (row r, word
    c) into the chunk's removed word, until none is open; then OR the
    later words of the rows kept in chunk c into ``removed``."""
    words = -(-n // WORD)
    removed = [0] * words
    kept = []
    for c in range(words):
        if len(kept) >= ndet:
            break
        in_chunk = min(WORD, n - c * WORD)
        rem = removed[c] | ((FULL << in_chunk) & FULL)
        keep = []
        while rem != FULL and len(kept) < ndet:
            r = (~rem & -~rem).bit_length() - 1
            keep.append(c * WORD + r)
            kept.append(c * WORD + r)
            rem |= (1 << r) | rows[c * WORD + r][c]
        for w in range(c + 1, words):
            for p in keep:
                removed[w] |= rows[p][w]
    return kept


def bitmask_nms(scores, boxes, classes, thr=0.5, ndet=NDET):
    """The kernel's three steps on the CPU, per image: rank, mask, scan.
    Same outputs as ``nms_rotated_plain``."""
    scores, boxes, classes = scores.float(), boxes.float(), classes.float()
    b = scores.shape[0]
    out_s = torch.zeros(b, ndet)
    out_b = torch.zeros(b, ndet, 6)
    out_c = torch.zeros(b, ndet)
    if scores.shape[1] == 0:
        return out_s, out_b, out_c
    corners = sincos_box_corners(boxes)
    for img in range(b):
        order = _rank_order(scores[img])
        rows = _mask_words(corners[img][order], classes[img][order], thr)
        kept = order[_scan(rows, order.shape[0], ndet)]
        out_s[img, :len(kept)] = scores[img, kept]
        out_b[img, :len(kept)] = boxes[img, kept]
        out_c[img, :len(kept)] = classes[img, kept]
    return out_s, out_b, out_c


def _smoke_case(n):
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(__file__), '..',
                                   'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return [t.numpy() for t in smoke.synthetic_rotated_nms_case(n=n)]


def nms_case(kind, b=2, n=300, seed=0):
    """(x1, y1, x2, y2, sin, cos) boxes in clusters, scores with a third
    zero, 4 classes; each kind plants what it names."""
    if kind == 'synthetic':
        return _smoke_case(n)
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(40, 400, (b, 20, 2))
    ctr = np.take_along_axis(ctr, rng.randint(0, 20, (b, n))[..., None], 1)
    ctr = ctr + rng.uniform(-8, 8, (b, n, 2))
    wh = rng.uniform(8, 70, (b, n, 2))
    th = rng.uniform(-np.pi / 2, np.pi / 2, (b, n))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2, np.sin(th)[..., None],
                            np.cos(th)[..., None]], -1)
    scores = rng.rand(b, n)
    scores[rng.rand(b, n) < 0.33] = 0.0
    classes = rng.randint(0, 4, (b, n))
    if kind == 'ties':
        scores = np.ceil(scores * 8) / 8
    elif kind == 'copies':
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :boxes[:, 1::3].shape[1]]
        classes[:, 1::3] = classes[:, 0:-1:3][:, :classes[:, 1::3].shape[1]]
    elif kind == 'shared_corners':
        boxes[:, 1::2, :2] = boxes[:, 0::2, :2][:, :boxes[:, 1::2].shape[1]]
        boxes[:, 1::2, 4:] = [0.0, 1.0]
        boxes[:, 0::2, 4:] = [0.0, 1.0]
    elif kind == 'pad_pair':
        # 10x10 inside 20x10 at one corner: IoU 0.5 but for the pad
        boxes[:, 0] = [500, 500, 520, 510, 0, 1]
        boxes[:, 1] = [500, 500, 510, 510, 0, 1]
        scores[:, :2] = [1.0, 0.5]
        classes[:, :2] = 7
    elif kind == 'zeros':
        scores[:] = 0.0
    elif kind == 'one_class':
        classes[:] = 0
    elif kind == 'many_classes':
        classes = rng.randint(0, 80, (b, n))
    elif kind == 'nonfinite':
        boxes[:, 0, 0] = np.nan
        boxes[:, 1, 2] = np.inf
        boxes[:, 2, 4:] = np.nan
        scores[:, :3] = [1.0, 0.99, 0.98]
        classes[:, :4] = 1
    elif kind == 'nan_scores':
        scores[0, 7] = np.nan             # image 0 records nothing
        scores[1, 3] = -np.inf            # a dead candidate, not a NaN
    return (scores.astype(np.float32), boxes.astype(np.float32),
            classes.astype(np.float32))


CASES = [('ties', 300), ('copies', 300), ('shared_corners', 300),
         ('pad_pair', 300), ('zeros', 300), ('fewer_than_ndet', 40),
         ('one_class', 300), ('many_classes', 300), ('nonfinite', 300),
         ('nan_scores', 300), ('synthetic', 300)]


@pytest.mark.parametrize('kind,n', CASES)
def test_bitmask_nms_equals_greedy_and_jax(kind, n):
    """The rank / mask / scan algorithm gives the greedy rounds' outputs
    exactly: those of the port's plain version and of the JAX package's
    jnp form on the CPU."""
    scores, boxes, classes = nms_case(kind, n=n)
    s, b, c = (torch.from_numpy(a) for a in (scores, boxes, classes))
    got = bitmask_nms(s, b, c)
    want = nms_rotated_plain(s, b, c, 0.5, NDET)
    jax_out = _jax_nms(scores, boxes, classes)
    for g, w, j in zip(got, want, jax_out):
        # equal, a NaN box copied through as NaN on all three
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    kept = (got[0] > 0).sum(1)
    if kind == 'zeros':
        assert (kept == 0).all()
    elif kind == 'nan_scores':
        assert not any(t[0].any() for t in got) and (kept[1] > 0)
    else:
        assert (kept > 0).all() and (got[0][:, :-1] >= got[0][:, 1:]).all()
    if kind == 'fewer_than_ndet':
        assert (kept < n).all()


def test_bitmask_nms_on_no_candidates():
    """N = 0: all zeros, as the plain version gives (the JAX jnp form
    refuses an argmax over no candidates)."""
    s, b, c = torch.zeros(2, 0), torch.zeros(2, 0, 6), torch.zeros(2, 0)
    got = bitmask_nms(s, b, c)
    want = nms_rotated_plain(s, b, c, 0.5, NDET)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and not g.any()


def test_pad_pair_is_kept_and_suppression_is_exercised():
    """The planted pair sits just under the threshold (the pad) and both
    stay; copies of a kept box of its class are suppressed."""
    s, b, c = (torch.from_numpy(a) for a in nms_case('pad_pair'))
    out_s = bitmask_nms(s, b, c)[0]
    assert ((out_s == 1.0).any(1) & (out_s == 0.5).any(1)).all()
    s, b, c = (torch.from_numpy(a) for a in nms_case('copies'))
    kept = (bitmask_nms(s, b, c)[0] > 0).sum(1)
    assert (kept < (s > 0).sum(1)).all()


def test_skip_rule_never_skips_an_overlapping_pair():
    """Over dense clusters of rotated boxes (many pairs touching or nearly
    so, shared corners, copies) every pair the rule skips clips to an IoU
    of exactly 0, and the rule skips most far pairs."""
    scores, boxes, _ = nms_case('shared_corners', b=1, n=500, seed=3)
    q = sincos_box_corners(torch.from_numpy(boxes[0]))
    n = q.shape[0]
    cx, cy = _corner_lists(q, 1)
    iou = clip_iou(q[None].expand(n, n, 8), cx, cy)      # [i, j]
    skip = skipped(q)
    assert skip.float().mean() > 0.5
    assert (iou[skip] == 0).all()
    # boxes just apart: each is widened by the margin, so a gap of 0.6 is
    # skipped and one of 0.4 clipped
    base = torch.tensor([100.0, 100.0, 120.0, 110.0, 0.0, 1.0])
    for gap, want in ((0.6, True), (0.4, False)):
        other = base + torch.tensor([20.0 + gap, 0, 20.0 + gap, 0, 0, 0])
        pair = sincos_box_corners(torch.stack([base, other]))
        assert bool(skipped(pair)[0, 1]) == want


def test_nonfinite_quads_are_always_clipped():
    """A quad with a NaN or an infinite corner is never skipped, so the
    clip's NaN rule decides."""
    boxes = torch.tensor([[0.0, 0, 10, 10, 0, 1],
                          [float('nan'), 0, 10, 10, 0, 1],
                          [1000.0, 1000, float('inf'), 1010, 0, 1]])
    skip = skipped(sincos_box_corners(boxes))
    assert not skip[0, 1] and not skip[1, 2] and not skip[0, 2]


def test_scan_jumps_over_removed_words():
    """Ranks spread over 70 words: a chain where each kept rank removes
    everything up to far chunks, and a chunk whose rows keep several ranks,
    scanned to the same kept list as a rank-by-rank walk."""
    n = 64 * 70                                   # 70 words
    rows = [[0] * 70 for _ in range(n)]
    for p in (0, 2100, 4000):                     # remove up to the next
        for j in range(p + 1, min(p + 2100, n)):
            rows[p][j // WORD] |= 1 << (j % WORD)
    for p in range(4200, 4260, 3):                # every other one removed
        rows[p][(p + 1) // WORD] |= 1 << ((p + 1) % WORD)
    kept = _scan(rows, n, NDET)
    walk, removed = [], set()
    for p in range(n):
        if p not in removed and len(walk) < NDET:
            walk.append(p)
            removed |= {j for j in range(n)
                        if rows[p][j // WORD] >> (j % WORD) & 1}
    assert kept == walk and kept[:3] == [0, 2100, 4200]
