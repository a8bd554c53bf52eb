"""The axis-aligned NMS kernel's algorithm (csrc/nms.cu with the rank and
scan of csrc/nms_scan.cuh), written out in plain torch here, against the
greedy rounds it replaces.

The kernel ranks the live candidates by counting (score descending, index
ascending; no candidate of an image holding a NaN score), sets bit (i, j)
of a suppression bitmask over 64-rank words iff i is ranked before j, the
classes are equal and the IoU of candidate j against winner i is above the
threshold (a NaN IoU sets no bit), and scans it one word-skipping step per
kept detection. ``axis_bitmask_nms`` repeats those steps on the CPU; the
tests hold it equal to ``nms_plain`` (the greedy rounds) and to the JAX
package's ``odtk_tpu/ops/nms.py:nms``, its jnp rounds and ``nms_pallas``
in interpret mode.
"""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops.nms import nms as jax_nms
from odtk_tpu.ops.pallas import nms_kernel as jax_nms_kernel
from odtk_tpu_torch.ops.kernels.nms import nms_plain

from test_torch_nms_bitmask import WORD, _rank_order, _scan
from torch_threads import one_torch_thread  # noqa: F401

NDET = 100


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Force pallas_call into interpreter mode (no TPU here)."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs['interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_nms_kernel.pl, 'pallas_call', patched)


def _mask_rows(boxes, cls, thr):
    """Row i's 64-bit words: bit j set iff i is ranked before j, same
    class, and the IoU of j against i (+1 widths, candidate area first,
    NaN carried through) > thr."""
    n = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = (torch.minimum(x2[None], x2[:, None])
          - torch.maximum(x1[None], x1[:, None]) + 1).clamp(min=0)
    ih = (torch.minimum(y2[None], y2[:, None])
          - torch.maximum(y1[None], y1[:, None]) + 1).clamp(min=0)
    inter = iw * ih                                        # [i, j]
    iou = inter / (area[None] + area[:, None] - inter)
    bits = ((cls[:, None] == cls[None])
            & torch.ones(n, n, dtype=torch.bool).triu(1) & (iou > thr))
    words = -(-n // WORD)
    packed = np.packbits(np.pad(bits.numpy(), ((0, 0), (0, words * WORD - n))),
                         axis=1, bitorder='little')
    return [[int.from_bytes(packed[i, 8 * w:8 * w + 8].tobytes(), 'little')
             for w in range(words)] for i in range(n)]


def axis_bitmask_nms(scores, boxes, classes, thr=0.5, ndet=NDET):
    """The kernel's three steps on the CPU, per image: rank, mask, scan.
    Same outputs as ``nms_plain``."""
    scores, boxes, classes = scores.float(), boxes.float(), classes.float()
    b = scores.shape[0]
    out_s = torch.zeros(b, ndet)
    out_b = torch.zeros(b, ndet, 4)
    out_c = torch.zeros(b, ndet)
    for img in range(b):
        order = _rank_order(scores[img])
        rows = _mask_rows(boxes[img][order], classes[img][order], thr)
        kept = order[_scan(rows, order.shape[0], ndet)]
        out_s[img, :len(kept)] = scores[img, kept]
        out_b[img, :len(kept)] = boxes[img, kept]
        out_c[img, :len(kept)] = classes[img, kept]
    return out_s, out_b, out_c


def axis_case(kind, b=2, n=300, seed=0):
    """Integer-coordinate boxes in clusters (areas and intersections exact
    in fp32), scores with a third zero, 4 classes; each kind plants what
    it names."""
    rng = np.random.RandomState(seed)
    ctr = rng.randint(30, 300, (b, 25, 2))
    ctr = np.take_along_axis(ctr, rng.randint(0, 25, (b, n))[..., None], 1)
    ctr = ctr + rng.randint(-6, 7, (b, n, 2))
    wh = rng.randint(4, 60, (b, n, 2))
    boxes = np.concatenate([ctr - wh // 2, ctr + wh // 2], -1)
    scores = rng.rand(b, n)
    scores[rng.rand(b, n) < 0.33] = 0.0
    classes = rng.randint(0, 4, (b, n))
    if kind == 'ties':
        scores = np.ceil(scores * 8) / 8
    elif kind == 'iou_at_threshold':
        # 20x10 and 10x10 at one corner: inter 100 / union 200 = 0.5, kept;
        # an 11x10 box beside them is above 0.5 against the first, removed
        boxes[:, :3] = [[900, 900, 919, 909], [900, 900, 909, 909],
                        [900, 900, 910, 909]]
        scores[:, :3] = [0.99, 0.98, 0.97]
        classes[:, :3] = 9
    elif kind == 'copies':
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :boxes[:, 1::3].shape[1]]
        classes[:, 1::3] = classes[:, 0:-1:3][:, :classes[:, 1::3].shape[1]]
    elif kind == 'class_collisions':
        # copies of one box under other classes are never suppressed
        boxes[:, 1::2] = boxes[:, 0:-1:2][:, :boxes[:, 1::2].shape[1]]
        classes[:, 1::2] = (classes[:, 0:-1:2][:, :classes[:, 1::2].shape[1]]
                            + 1) % 4
    elif kind == 'nan_scores':
        scores[0, 11] = np.nan            # image 0 records nothing
        scores[1, 5] = -np.inf            # a dead candidate, not a NaN
    elif kind == 'nonfinite_boxes':
        boxes = boxes.astype(np.float64)
        boxes[:, 0, 0] = np.nan           # its IoUs are NaN: no bit
        boxes[:, 1, 2] = np.inf
        scores[:, :3] = [1.0, 0.99, 0.98]
        classes[:, :3] = 1
    return (scores.astype(np.float32), boxes.astype(np.float32),
            classes.astype(np.float32))


CASES = [('ties', 300), ('iou_at_threshold', 300), ('copies', 300),
         ('class_collisions', 300), ('nan_scores', 300),
         ('nonfinite_boxes', 300), ('random', 1500)]


@pytest.mark.parametrize('kind,n', CASES)
def test_axis_bitmask_nms_equals_greedy_and_jax(interpret_pallas, kind, n):
    """The rank / mask / scan algorithm gives the greedy rounds' outputs
    exactly: the port's plain version, the JAX jnp rounds and the JAX
    Pallas kernel in interpret mode."""
    scores, boxes, classes = axis_case(kind, n=n)
    s, b, c = (torch.from_numpy(a) for a in (scores, boxes, classes))
    got = axis_bitmask_nms(s, b, c)
    want = nms_plain(s, b, c, 0.5, NDET)
    args = (jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(classes),
            0.5, NDET)
    rounds = jax_nms(*args, use_pallas=False)
    pallas = jax_nms_kernel.nms_pallas(*args)
    for g, w, r, p in zip(got, want, rounds, pallas):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    kept = (got[0] > 0).sum(1)
    assert (got[0][:, :-1] >= got[0][:, 1:]).all()
    if kind == 'nan_scores':
        assert not any(t[0].any() for t in got) and kept[1] > 0
    else:
        assert (kept > 0).all()
    if kind == 'iou_at_threshold':
        assert (got[0] == np.float32(0.98)).any(1).all()
        assert not (got[0] == np.float32(0.97)).any()
    if kind == 'class_collisions':
        # each kept box's copy under the next class is kept as well
        assert (kept == NDET).all()


def test_axis_bitmask_nms_on_no_candidates():
    """N = 0: all zeros, as the plain version gives (the JAX jnp form
    refuses an argmax over no candidates)."""
    s, b, c = torch.zeros(2, 0), torch.zeros(2, 0, 4), torch.zeros(2, 0)
    got = axis_bitmask_nms(s, b, c)
    want = nms_plain(s, b, c, 0.5, NDET)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and not g.any()


@pytest.mark.parametrize('thr', [0.0, -1.0, 0.7])
def test_axis_bitmask_nms_thresholds(thr):
    """Thresholds at and below 0 (every same-class pair, also the disjoint
    ones, suppresses) and above 0.5, against the greedy rounds."""
    s, b, c = (torch.from_numpy(a) for a in axis_case('copies'))
    got = axis_bitmask_nms(s, b, c, thr)
    want = nms_plain(s, b, c, thr, NDET)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
