"""The multi-level detection loss of odtk_tpu_torch on the CPU.

``detection_loss_sums_levels`` takes every FPN level of a step in one
call (one forward and one backward kernel launch on the card). Here: its
plain path equals the per-level plain sums and their gradients, and the
JAX package's fused loss level by level; the level table the kernels
share splits each level's positions between threads exactly once, on 16-byte
vectors where a level's HW allows; and ``Model.loss_fn`` makes one call
over all five levels. ``tests/test_torch_train.py`` and
``tests/test_torch_rotated_train.py`` hold ``Model.loss_fn`` itself
against the JAX ``Model.loss_fn``, axis-aligned and rotated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odtk_tpu.ops.pallas.focal_kernel import detection_loss_sums_fused
from odtk_tpu_torch import model as model_mod
from odtk_tpu_torch.model import Model
from odtk_tpu_torch.ops.kernels import loss as kloss
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = 3


def _level(rng, h, w, anchors, dim, b=2):
    """numpy inputs of one level: NHWC heads, class indices, deltas and
    depths with ignored, background and foreground anchors."""
    n = h * w * anchors
    x = (rng.randn(b, h, w, anchors * CLASSES) * 3).astype(np.float32)
    bx = (rng.randn(b, h, w, anchors * dim) * 0.3).astype(np.float32)
    cls = rng.randint(0, CLASSES, (b, n)).astype(np.int32)
    depth = rng.choice([-1.0, 0.0, 0.0], (b, n))
    fg = rng.rand(b, n) < 0.1
    depth[fg] = cls[fg] + 1
    box_t = (rng.randn(b, n, dim) * 0.3).astype(np.float32)
    return x, bx, cls, box_t, depth.astype(np.float32)


SHAPES = [(4, 6), (2, 3), (1, 2)]


@pytest.mark.parametrize('anchors,dim', [(9, 4), (27, 6)])
def test_levels_plain_equals_per_level_sums(anchors, dim):
    """The CPU path of ``detection_loss_sums_levels`` is the plain
    version a level at a time: sums and gradients equal."""
    rng = np.random.RandomState(dim)
    levels = [[torch.from_numpy(a) for a in _level(rng, h, w, anchors, dim)]
              for h, w in SHAPES]
    g = torch.from_numpy(rng.uniform(0.1, 2.0, (len(SHAPES), 2))
                         .astype(np.float32))
    heads = [(lv[0].clone().requires_grad_(True),
              lv[1].clone().requires_grad_(True)) for lv in levels]
    sums = kloss.detection_loss_sums_levels(
        [x for x, _ in heads], [bx for _, bx in heads],
        *([lv[i] for lv in levels] for i in (2, 3, 4)), CLASSES)
    assert sums.shape == (len(SHAPES), 2) and sums.dtype == torch.float32
    got = torch.autograd.grad((sums * g).sum(),
                              [t for pair in heads for t in pair])
    for i, lv in enumerate(levels):
        x = lv[0].clone().requires_grad_(True)
        bx = lv[1].clone().requires_grad_(True)
        c, s = kloss.detection_loss_sums_plain(x, bx, *lv[2:], CLASSES)
        want = torch.autograd.grad(g[i, 0] * c + g[i, 1] * s, (x, bx))
        assert torch.equal(sums[i], torch.stack([c, s]).detach())
        assert torch.equal(got[2 * i], want[0])
        assert torch.equal(got[2 * i + 1], want[1])


@pytest.mark.parametrize('dim', [4, 6])
def test_plain_float64_box_gradient_is_the_closed_form(dim):
    """Float64 heads stay float64 through the plain version (the
    reference of the kernels' gradient checks on the card), and its box
    gradient is the closed form fg clamp((box - box_t) / beta, -1, 1)."""
    rng = np.random.RandomState(dim)
    x, bx, cls, box_t, depth = (torch.from_numpy(a) for a in _level(
        rng, 4, 6, 3, dim))
    x64 = x.double().requires_grad_(True)
    bx64 = bx.double().requires_grad_(True)
    c, s = kloss.detection_loss_sums_plain(x64, bx64, cls, box_t, depth,
                                           CLASSES)
    assert c.dtype == s.dtype == torch.float64
    dx, dbx = torch.autograd.grad(c + s, (x64, bx64))
    assert dx.dtype == dbx.dtype == torch.float64
    b = x.shape[0]
    d = bx.double().reshape(b, -1, dim) - box_t.double()
    want = (d / 0.11).clamp(-1, 1) * (depth > 0)[..., None]
    torch.testing.assert_close(dbx.reshape(b, -1, dim), want, rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize('anchors,dim', [(9, 4), (27, 6)])
def test_levels_match_jax_fused_loss(anchors, dim):
    """Three ragged levels against the JAX package's
    ``detection_loss_sums_fused`` (interpret mode) a level at a time:
    sums at rtol 1e-5 (summation order), gradients within 1e-4 of each
    tensor's largest entry (closed form vs autograd)."""
    rng = np.random.RandomState(20 + dim)
    levels = [_level(rng, h, w, anchors, dim) for h, w in SHAPES]
    heads = [(torch.from_numpy(x).requires_grad_(True),
              torch.from_numpy(bx).requires_grad_(True))
             for x, bx, *_ in levels]
    sums = kloss.detection_loss_sums_levels(
        [x for x, _ in heads], [bx for _, bx in heads],
        *([torch.from_numpy(lv[i]) for lv in levels] for i in (2, 3, 4)),
        CLASSES)
    got = torch.autograd.grad(sums[:, 0].sum() + 2.0 * sums[:, 1].sum(),
                              [t for pair in heads for t in pair])
    for i, (x, bx, cls, box_t, depth) in enumerate(levels):
        def total(x_, bx_):
            c, s = detection_loss_sums_fused(
                x_, bx_, jnp.asarray(cls, jnp.float32), jnp.asarray(box_t),
                jnp.asarray(depth), classes=CLASSES, interpret=True)
            return c + 2.0 * s, (c, s)

        (_, (w_c, w_s)), w_grads = jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                 jnp.asarray(bx))
        np.testing.assert_allclose(sums[i].detach().numpy(),
                                   [float(w_c), float(w_s)], rtol=1e-5)
        for mine, want in zip(got[2 * i:2 * i + 2], w_grads):
            want = np.asarray(want)
            np.testing.assert_allclose(mine.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def _thread_cover(hws, batch, anchors, vector_ok):
    """Replays the kernels' thread mapping over ``level_table``'s rows:
    per level, how often each (image x anchor, position) is taken, the
    vector flag, and the blocks of all levels."""
    rows, blocks = kloss.level_table(hws, batch, anchors, vector_ok)
    ends = [r[3] for r in rows[1:]] + [blocks]
    cover = []
    for (hw, vec, chunks, block0), end in zip(rows, ends):
        items = np.arange((end - block0) * kloss.THREADS)
        items = items[items < batch * anchors * chunks]   # threads with work
        ba, hw0 = items // chunks, (items % chunks) * kloss.VECTOR
        count = np.minimum(kloss.VECTOR, hw - hw0)
        taken = np.zeros((batch * anchors, hw), np.int64)
        for m in range(kloss.VECTOR):
            on = m < count
            np.add.at(taken, (ba[on], hw0[on] + m), 1)
        cover.append((taken, vec))
    return rows, blocks, cover


@pytest.mark.parametrize('hws,batch,anchors,vector_ok,vec', [
    # the five levels of the 896 x 1152 train canvas, batch 8, 9 anchors:
    # P3-P5 on vectors, P6 (252) and P7 (63) scalar
    ([112 * 144, 56 * 72, 28 * 36, 14 * 18, 7 * 9], 8, 9, [True] * 5,
     [1, 1, 1, 0, 0]),
    # ragged: a single position, an unaligned level, 27 anchors
    ([273, 1, 64, 7 * 9, 16], 2, 27, [True, True, False, True, True],
     [0, 0, 0, 0, 1]),
])
def test_level_table_splits_each_level_once(hws, batch, anchors,
                                             vector_ok, vec):
    """Every position of every (image, anchor) row of every level is
    taken by exactly one thread of exactly one block of its level; the
    levels' blocks follow one another from 0; a level goes on 16-byte
    vectors exactly where its HW is a multiple of 8 and its tensors are
    aligned."""
    rows, blocks, cover = _thread_cover(hws, batch, anchors, vector_ok)
    assert [r[0] for r in rows] == hws and rows[0][3] == 0
    assert [r[1] for r in rows] == vec
    assert all(a[3] < b[3] for a, b in zip(rows, rows[1:]))
    assert blocks == sum(-(-batch * anchors * r[2] // kloss.THREADS)
                         for r in rows)
    for taken, _ in cover:
        assert (taken == 1).all()


def test_levels_reject_mismatched_lists():
    x, bx, cls, box_t, depth = (torch.from_numpy(a) for a in _level(
        np.random.RandomState(0), 2, 2, 9, 4))
    with pytest.raises(ValueError):
        kloss.detection_loss_sums_levels([x, x], [bx], [cls], [box_t],
                                         [depth], CLASSES)
    with pytest.raises(ValueError):
        kloss.detection_loss_sums_levels([], [], [], [], [], CLASSES)


@pytest.mark.parametrize('rotated', [False, True])
def test_loss_fn_makes_one_loss_call_for_all_levels(monkeypatch, rotated):
    """``Model.loss_fn`` assigns every level first, then calls the loss
    once with the five levels' heads and targets; its losses are the
    level sums over the foreground count."""
    calls = []

    def counted(*args, **kwargs):
        out = kloss.detection_loss_sums_levels(*args, **kwargs)
        fg = sum(max(int((d > 0).sum()), 1) for d in args[4])
        calls.append(([len(a) for a in args[:5]], out.detach().clone(), fg))
        return out

    monkeypatch.setattr(model_mod, 'detection_loss_sums_levels', counted)
    model = Model('ResNet18FPN', classes=CLASSES, rotated_bbox=rotated)
    model.initialize(0)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(2, 128, 128, 3).astype(np.float32))
    if rotated:
        targets = torch.tensor([[[40.0, 40, 50, 30, 0.3, 1],
                                 [90, 80, 30, 60, -0.2, 2]],
                                [[64, 64, 70, 40, 0.0, 0],
                                 [-1, -1, -1, -1, -1, -1]]])
    else:
        targets = torch.tensor([[[20.0, 20, 50, 30, 1], [70, 60, 30, 60, 2]],
                                [[30, 40, 70, 40, 0], [-1, -1, -1, -1, -1]]])
    cls_loss, box_loss = model.loss_fn(images, targets)
    assert len(calls) == 1
    lens, sums, fg = calls[0]
    assert lens == [5] * 5 and fg >= 1
    assert torch.isfinite(sums).all() and (sums[:, 0] > 0).all()
    assert torch.equal(cls_loss.detach(), sums[:, 0].sum() / fg)
    assert torch.equal(box_loss.detach(), sums[:, 1].sum() / fg)
